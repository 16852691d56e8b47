"""linemod_tpu_torch — the PyTorch + CUDA port of linemod_tpu.

The same LINE-MOD detection pipeline as `linemod_tpu/`, in plain PyTorch on
tensors, with every Pallas kernel of the JAX package as a hand-written CUDA
kernel for Hopper (`csrc/similarity.cu`, `csrc/probes.cu`). The layout
mirrors `linemod_tpu/` module for module. Nothing here imports `linemod_tpu`,
JAX, OpenCV or PyYAML: the numpy-only modules it needs (`types`,
`utils/geometry`, `utils/ply`, `ops/postprocess`) are its own copies.
"""

__version__ = "0.1.0"
