"""Typed configuration for the port (copy of the fields of
snvc_tpu/config.py:60-230, :264-348 and :351-362 that serving, the data
pipelines and the two trainings read).

Frozen dataclasses, as in the JAX package; nothing here imports JAX or
snvc_tpu.  ``load_config`` reads a ``config.json`` written by either
package: it drops the JAX fields that nothing in the port reads
(``_UNREAD``) and refuses a field neither package knows.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Type, TypeVar


@dataclass(frozen=True)
class HRNetStageConfig:
    """One HRNet stage (reference: snvc/models/hrnet.py:276-311)."""

    num_modules: int = 1
    num_branches: int = 1
    block: str = "bottleneck"  # "basic" | "bottleneck"
    num_blocks: Tuple[int, ...] = (4,)
    num_channels: Tuple[int, ...] = (64,)


def hrnet_w32_stages() -> Tuple[HRNetStageConfig, ...]:
    return (
        HRNetStageConfig(1, 1, "bottleneck", (4,), (64,)),
        HRNetStageConfig(1, 2, "basic", (4, 4), (32, 64)),
        HRNetStageConfig(4, 3, "basic", (4, 4, 4), (32, 64, 128)),
        HRNetStageConfig(3, 4, "basic", (4, 4, 4, 4), (32, 64, 128, 256)),
    )


def hrnet_w48_stages() -> Tuple[HRNetStageConfig, ...]:
    return (
        HRNetStageConfig(1, 1, "bottleneck", (4,), (64,)),
        HRNetStageConfig(1, 2, "basic", (4, 4), (48, 96)),
        HRNetStageConfig(4, 3, "basic", (4, 4, 4), (48, 96, 192)),
        HRNetStageConfig(3, 4, "basic", (4, 4, 4, 4), (48, 96, 192, 384)),
    )


def hrnet_tiny_stages() -> Tuple[HRNetStageConfig, ...]:
    """Small stages for tests (not in the reference)."""
    return (
        HRNetStageConfig(1, 1, "bottleneck", (1,), (16,)),
        HRNetStageConfig(1, 2, "basic", (1, 1), (8, 16)),
        HRNetStageConfig(1, 3, "basic", (1, 1, 1), (8, 16, 32)),
        HRNetStageConfig(1, 4, "basic", (1, 1, 1, 1), (8, 16, 32, 64)),
    )


def hrnet_multi_stages() -> Tuple[HRNetStageConfig, ...]:
    """Small stages with repeated modules (2 / 3 / 2) and a 4-branch last
    stage: the w32 / w48 enumeration at test size (JAX
    ``hrnet_multi_stages``), which pins the converter's ordering of
    repeated modules."""
    return (
        HRNetStageConfig(1, 1, "bottleneck", (2,), (16,)),
        HRNetStageConfig(2, 2, "basic", (2, 2), (8, 16)),
        HRNetStageConfig(3, 3, "basic", (2, 2, 2), (8, 16, 32)),
        HRNetStageConfig(2, 4, "basic", (2, 2, 2, 2), (8, 16, 32, 64)),
    )


_STAGES = {"hrnet-w32": hrnet_w32_stages, "hrnet-w48": hrnet_w48_stages,
           "hrnet-tiny": hrnet_tiny_stages,
           "hrnet-test-multi": hrnet_multi_stages}


@dataclass(frozen=True)
class BackboneConfig:
    """2D feature extractor config (reference: hrnet.get_model).
    ``head_type`` is the head an ``HRNet`` built without one gets; the
    Vernier model names its HRNets' heads itself, as JAX's does."""

    # hrnet-w48 | hrnet-w32 | hrnet-tiny | hrnet-test-multi
    name: str = "hrnet-w32"
    head_type: str = "default"  # default | classification | heatmap_regression
    add_xy: bool = False

    def stages(self) -> Tuple[HRNetStageConfig, ...]:
        if self.name not in _STAGES:
            raise ValueError(f"unknown backbone {self.name}")
        return _STAGES[self.name]()

    @property
    def output_channel(self) -> int:
        return self.stages()[1].num_channels[0]


@dataclass(frozen=True)
class VernierConfig:
    """Instance refinement model + serving config (the fields of the JAX
    VernierConfig that the serving path reads, with the same defaults)."""

    # --- model ---
    vernier_type: str = "BEV_type3"  # 3D | BEV | BEV_type2 | BEV_type3
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    gn: bool = True
    gn_groups: int = 32
    num_parts: int = 9
    use_bbox_head: bool = False
    use_part_reg_head: bool = False
    feature_aggregation: str = "concat"  # concat | concat-atten
    # NCF heatmap loss: "mse" or "mse_weighted" (models/losses.py)
    ncf_loss: str = "mse"
    # --- instance grid: (nh, nw, nl) samples along (height, width, length)
    grid_resolution: Tuple[int, int, int] = (16, 96, 96)
    x_range: Tuple[float, float] = (-2.4, 2.4)
    y_range: Tuple[float, float] = (-1.0, 1.0)
    z_range: Tuple[float, float] = (-2.4, 2.4)
    # --- training targets (ops/assemble.make_targets) ---
    sigma: int = 2  # gaussian radius (voxels) of the part heatmaps
    ncf_subvoxel: bool = False  # draw at fractional voxel coordinates
    grid_type: str = "2D"  # "2D" (BEV heatmaps) | "3D" (3D fields)
    # --- ROI cropping ---
    resolution: Tuple[int, int] = (256, 256)  # (height, width) of the ROI
    roi_enlarge: float = 1.1
    img_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    img_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # --- data / augmentation (data/instance_db.py, data/pipeline.py) ---
    usage: str = "inference"  # train | inference
    sup_type: str = "real"  # synthetic (sample around GT) | real (proposals)
    pred_dir: str = ""
    depth_range: Tuple[float, float] = (0.0, 60.0)
    valid_classes: Tuple[int, ...] = (2,)  # Car(+Van)=2 in the KITTI mapping
    augment: bool = True
    augment_times: int = 1
    rot_aug: bool = True
    loc_aug: bool = True
    dim_aug: bool = False
    std_rot: float = 5.0  # degrees
    std_loc: Tuple[float, float, float] = (0.2, 0.05, 0.2)
    std_dim: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    check_fov: bool = False
    # --- batching ---
    max_instances: int = 8
    frames_per_batch: int = 1  # image slots of one batch
    image_size: Tuple[int, int] = (384, 1280)
    # --- pose update / output ---
    ncf_decode: str = "coordinates"  # coordinates | argmax | soft-argmax
    filter_min: float = -1.0
    filter_max: float = 2.0
    pred_type: Tuple[str, ...] = ("all_parts",)
    output_dir: str = "outputs"
    # --- numerics ---
    compute_dtype: str = "bfloat16"
    # rematerialize the 3D hourglass in training (torch.utils.checkpoint);
    # also names its parameters as the JAX model does (its nn.remat
    # wrapper prefixes "Checkpoint")
    remat: bool = True

    @property
    def n_sample_h(self) -> int:
        return self.grid_resolution[0]

    @property
    def n_sample_w(self) -> int:
        return self.grid_resolution[1]

    @property
    def n_sample_l(self) -> int:
        return self.grid_resolution[2]

    @property
    def grid_range(self) -> Tuple[float, float, float]:
        """(h, w, l) extent of the refinement space in meters."""
        return (
            self.y_range[1] - self.y_range[0],
            self.x_range[1] - self.x_range[0],
            self.z_range[1] - self.z_range[0],
        )

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """Voxel pitch (dy, dx, dz) of the linspace grid (n points
        spanning the range: pitch = range / (n - 1); JAX config.py:
        253-260, the reference's cfg.spacing)."""
        nh, nw, nl = self.grid_resolution
        gh, gw, gl = self.grid_range
        return (gh / (nh - 1), gw / (nw - 1), gl / (nl - 1))

    def replace(self, **kw) -> "VernierConfig":
        return dataclasses.replace(self, **kw)


def tiny_vernier_config(**overrides) -> VernierConfig:
    """Small config for tests and CPU runs (JAX tiny_vernier_config)."""
    base = dict(
        backbone=BackboneConfig(name="hrnet-tiny"),
        grid_resolution=(8, 16, 16),
        resolution=(64, 64),
        gn_groups=4,
        max_instances=2,
        sigma=1,
        compute_dtype="float32",
        remat=False,
    )
    base.update(overrides)
    return VernierConfig(**base)


def flagship_vernier_config(**overrides) -> VernierConfig:
    """The release-scale serving config of ``bench.py --config flagship``:
    hrnet-w32, a 32x192x192 grid, 256x256 ROIs, 4 instances, bf16."""
    base = dict(
        backbone=BackboneConfig(name="hrnet-w32"),
        grid_resolution=(32, 192, 192),
        resolution=(256, 256),
        max_instances=4,
        compute_dtype="bfloat16",
        remat=True,
    )
    base.update(overrides)
    return VernierConfig(**base)


@dataclass(frozen=True)
class TrainConfig:
    """Training settings (JAX TrainConfig, same fields and defaults); the
    stereo step reads the optimizer's fields."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 80000
    batch_size: int = 8  # global batch (instances for vernier, pairs for stereo)
    occupancy_weight: float = 1.0
    coordinate_weight: float = 0.1
    grad_clip: float = 10.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1000


@dataclass(frozen=True)
class StereoConfig:
    """Global stereo detector config (the fields of the JAX StereoConfig
    that detection serving and stereo training read, with the same
    defaults: the full-width model ``bench.py --model stereo`` serves)."""

    backbone: str = "reslike-det-small"
    gn: bool = True
    branch: bool = True  # SPP branches
    plane_sweep_volume: bool = True
    cat_img_feature: bool = True
    rpn3d_enable: bool = True
    rpn_convdim: int = 64
    # depth hypotheses for the plane sweep
    num_depths: int = 64
    min_depth: float = 2.0
    max_depth: float = 59.6
    # scene voxel / BEV grid (camera rect frame)
    x_min: float = -30.0
    x_max: float = 30.0
    y_min: float = -1.0
    y_max: float = 3.0
    z_min: float = 2.0
    z_max: float = 59.6
    voxel_x: float = 0.2
    voxel_y: float = 0.2
    voxel_z: float = 0.2
    # RPN head
    num_classes: int = 1
    # class slot k <-> KITTI type name (the stereo pipeline's GT classes
    # and the proposal writer's type column)
    class_names: Tuple[str, ...] = ("Car",)
    num_angles: int = 2
    # yaw of each angle bin (training's target assignment)
    anchor_angles: Tuple[float, ...] = (0.0, 1.5707963)
    anchors_y: Tuple[float, ...] = (1.65,)
    # sigmoid focal loss of the classification maps
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    num_hourglasses: int = 1
    # depth supervision: "sl1" (multi-stage smooth-L1 on the regressed
    # depth) or "w1" (Wasserstein-1 over the depth distribution)
    depth_loss: str = "sl1"
    depth_offset: bool = False
    # score each positive's corners against both pi-rotated orderings
    reg_heading_sym: bool = False
    # view-consistent colour jitter + PCA lighting in training
    # (ops/augment.py, training/train_stereo.augment_normalize)
    photometric_aug: bool = False
    input_size: Tuple[int, int] = (384, 1248)
    compute_dtype: str = "bfloat16"

    @property
    def bev_size(self) -> Tuple[int, int]:
        nz = int(round((self.z_max - self.z_min) / self.voxel_z))
        nx = int(round((self.x_max - self.x_min) / self.voxel_x))
        return nz, nx

    @property
    def ny(self) -> int:
        return int(round((self.y_max - self.y_min) / self.voxel_y))

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


def tiny_stereo_config(**overrides) -> StereoConfig:
    """Small stereo config for tests and CPU runs (JAX tiny_stereo_config)."""
    base = dict(
        backbone="reslike50-det-tiny",
        num_depths=16,
        input_size=(64, 128),
        x_min=-8.0,
        x_max=8.0,
        z_min=2.0,
        z_max=18.0,
        voxel_x=0.5,
        voxel_y=1.0,
        voxel_z=0.5,
        compute_dtype="float32",
    )
    base.update(overrides)
    return StereoConfig(**base)


# Fields of the JAX configs that nothing in the port reads (JAX reads none
# of them either, or only its training CLIs do); ``load_config`` drops them.
_UNREAD = {
    "VernierConfig": ("head_reg_type", "aspect_ratio", "save", "debug"),
    "BackboneConfig": ("init_weights", "pre_trained_path"),
    "StereoConfig": ("align_corners", "cv_feature_dim", "hourglass_3d",
                     "num_3d_convs"),
}

C = TypeVar("C")


def _as_tuple(v):
    return tuple(_as_tuple(x) for x in v) if isinstance(v, list) else v


def _from_dict(cls: Type[C], d: Dict[str, Any]) -> C:
    """``cls`` from a JSON dict of the JAX package or of the port; raises
    on a field neither knows."""
    name = cls.__name__
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields - set(_UNREAD.get(name, ()))
    if unknown:
        raise ValueError(f"{name}: unknown fields {sorted(unknown)}")
    kw = {k: _as_tuple(v) for k, v in d.items() if k in fields}
    if "backbone" in kw and isinstance(kw["backbone"], dict):
        kw["backbone"] = _from_dict(BackboneConfig, kw["backbone"])
    return cls(**kw)


def save_config(cfg, path: str) -> None:
    """``cfg`` as ``config.json`` (the JSON ``load_config`` reads)."""
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)


def load_config(path: str, cls: Type[C]) -> C:
    """A ``VernierConfig`` or ``StereoConfig`` from ``config.json`` (JAX
    ``snvc_tpu/config.py:432``).  Takes the JAX package's files (a bare
    config, or an ExperimentConfig whose ``vernier`` / ``stereo`` entry is
    read) and the port's own (``training/train.save_checkpoint``)."""
    with open(path) as fh:
        d = json.load(fh)
    key = {VernierConfig: "vernier", StereoConfig: "stereo"}[cls]
    if isinstance(d.get(key), dict):
        d = d[key]
    return _from_dict(cls, d)
