"""Configuration: camera, template settings and model sidecars.

Counterpart of `linemod_tpu/config.py`, with the same dataclasses and field
names, read through `utils/yamlcv.read_yamlcv` instead of PyYAML.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .utils.yamlcv import read_yamlcv


@dataclasses.dataclass(frozen=True)
class CameraParameters:
    """Pinhole camera."""

    fx: float = 1044.87
    fy: float = 1045.69141
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    distortion: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def matrix(self) -> np.ndarray:
        """The 3x3 float64 intrinsic matrix."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def fov_y_deg(self) -> float:
        """Vertical field of view from fy, in degrees."""
        return float(np.degrees(2.0 * np.arctan(self.height / (2.0 * self.fy))))


@dataclasses.dataclass(frozen=True)
class TemplateSettings:
    """Template generation and detector knobs."""

    model_folder: str = "models/"
    model_file_ending: str = ".ply"
    only_color_modality: bool = True
    angle_start: int = -45
    angle_stop: int = 45
    angle_step: int = 10
    distance_start: int = 500
    distance_stop: int = 1200
    distance_step: int = 50
    subdivisions: int = 3
    detector_threshold: float = 80.0
    percent_to_pass_check: float = 50.0
    number_wanted_poses: int = 1
    group_radius: float = 45.0
    discard_group_ratio: float = 35.0
    use_depth_improvement: bool = True
    depth_offset: float = 30.0
    use_icp: bool = False
    icp_subsampling_factor: int = 2

    @property
    def in_plane_angles(self) -> np.ndarray:
        return np.arange(self.angle_start, self.angle_stop + 1, self.angle_step, dtype=np.float32)

    @property
    def radii(self) -> np.ndarray:
        return np.arange(
            self.distance_start, self.distance_stop + 1, self.distance_step, dtype=np.float32
        )


@dataclasses.dataclass(frozen=True)
class ModelProperties:
    """Per-model HSV range and symmetry."""

    lower_color_range: tuple = (0.0, 0.0, 0.0)
    upper_color_range: tuple = (255.0, 255.0, 255.0)
    rotationally_symmetrical: bool = False
    planes_of_symmetry: tuple = (0.0, 0.0, 0.0)


def load_settings(path: str = "linemod_settings.yml"):
    """Read a settings YAML into (CameraParameters, TemplateSettings)."""
    d = read_yamlcv(path)
    dist = d.get("distortion parameters")
    dist = tuple(np.asarray(dist).ravel()) if dist is not None else (0.0,) * 5
    cam = CameraParameters(
        fx=float(d["camera fx"]),
        fy=float(d["camera fy"]),
        cx=float(d["camera cx"]),
        cy=float(d["camera cy"]),
        width=int(d["video width"]),
        height=int(d["video height"]),
        distortion=dist,
    )
    ts = TemplateSettings(
        model_folder=str(d["model folder"]),
        model_file_ending=str(d["model file ending"]),
        only_color_modality=bool(int(d["only use color modality"])),
        angle_start=int(d["in plane rotation starting angle"]),
        angle_stop=int(d["in plane rotation stopping angle"]),
        angle_step=int(d["in plane rotation angle step"]),
        distance_start=int(d["distance start"]),
        distance_stop=int(d["distance stop"]),
        distance_step=int(d["distance step"]),
        subdivisions=int(d["icosahedron subdivisions"]),
        detector_threshold=float(d["detector threshold"]),
        percent_to_pass_check=float(d["percent to pass check"]),
        number_wanted_poses=int(d["number of poses to compare"]),
        group_radius=float(d["distance to match to be considered same object"]),
        discard_group_ratio=float(d["ratio to determine if group is too small"]),
        use_depth_improvement=bool(int(d["use depth improvement"])),
        depth_offset=float(d["depth offset"]),
        use_icp=bool(int(d["use icp"])),
        icp_subsampling_factor=int(d["icp subsampling factor"]),
    )
    return cam, ts


def load_model_properties(model_path: str) -> ModelProperties:
    """Read `<model>.yml` next to a mesh file (defaults when it is absent)."""
    path = os.path.splitext(model_path)[0] + ".yml"
    if not os.path.exists(path):
        return ModelProperties()
    d = read_yamlcv(path)
    lower = tuple(np.asarray(d.get("lower color range", (0, 0, 0, 0))).ravel()[:3])
    upper = tuple(np.asarray(d.get("upper color range", (255, 255, 255, 0))).ravel()[:3])
    planes = tuple(np.asarray(d.get("planes of symmetry", (0, 0, 0))).ravel()[:3])
    return ModelProperties(
        lower_color_range=lower,
        upper_color_range=upper,
        rotationally_symmetrical=bool(int(d.get("has rotational symmetry", 0))),
        planes_of_symmetry=planes,
    )


def files_in_directory(folder: str, ending: str) -> list:
    """The files of `folder` that end in `ending`, sorted (none when the
    folder does not exist)."""
    if not os.path.isdir(folder):
        return []
    return sorted(f for f in os.listdir(folder) if f.endswith(ending))
