"""Configuration: a copy of `mmgt_tpu/config.py` (`SchedulerConfig`,
`InferenceConfig`, the three training configs and `load_config`). PyYAML is
imported only when a `.yaml` file is passed; JSON files and overrides need
nothing beyond the standard library. The Stage-2 training configs'
`mesh_dp` / `mesh_tp` give the training CLIs' mesh (`parallel/mesh.py`,
read under torchrun), as in the JAX package."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class SchedulerConfig:
    """Stage-2 noise scheduler (config/prompts/animation.yaml:80-90)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 1
    clip_sample: bool = False
    # "ddim" (reference parity, pipeline_pose2vid_long.py:633-635) or
    # "dpm++2m" (beyond-reference few-step solver, diffusion/dpm.py —
    # ~25-step DDIM trajectory accuracy at 12-15 steps, see PERF.md)
    solver: str = "ddim"


@dataclasses.dataclass
class InferenceConfig:
    """audio2vid / pose2vid inference (animation.yaml + audio2vid.py
    defaults: 512^2, L=80, 30 steps, cfg 3.5, seed 42)."""

    width: int = 512
    height: int = 512
    video_length: int = 80
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    seed: int = 42
    fps: int = 25
    sample_rate: int = 16000
    # pose/face/lip weights. Reference-faithful default is (1,1,1): the
    # reference CLI exposes pose/face/lip_weight (animation.yaml:50-52,
    # lip 2.0) but its EVAL path never forwards motion_scale into the
    # audio blocks (unet_3d_blocks.py:590-598 — only the training
    # gradient-checkpoint call passes it), so the published demos run at
    # an effective (1,1,1). Ours actually honors non-1 values.
    motion_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    context_size: int = 12
    context_overlap: int = 4
    window_microbatch: Optional[int] = 5
    use_motion_selection: bool = False
    motion_candidates: int = 5
    a2p_feature_type: str = "wavlm"
    a2p_sampling_steps: int = 50
    a2p_guidance_weight: float = 2.0
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    # weight paths (optional; random init if absent)
    weights_dir: Optional[str] = None


@dataclasses.dataclass
class Stage1TrainConfig:
    """SMGA audio2pose training (args.py:24-25, SMGA.py:110-114)."""

    batch_size: int = 128
    epochs: int = 3400
    learning_rate: float = 2e-4
    weight_decay: float = 0.02
    feature_type: str = "wavlm"
    ema_decay: float = 0.9999
    cond_drop_prob: float = 0.25
    guidance_weight: float = 2.0
    checkpoint_dir: str = "checkpoints/stage1"
    checkpoint_every_epochs: int = 50
    data_dir: str = "data/stage1"
    seed: int = 0


@dataclasses.dataclass
class Stage2TrainConfig:
    """Stage-2 temporal/audio fine-tune (config/train/stage2.yaml)."""

    train_width: int = 512
    train_height: int = 512
    n_sample_frames: int = 12
    audio_margin: int = 2
    batch_size: int = 1
    max_train_steps: int = 32500
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    snr_gamma: float = 5.0
    noise_offset: float = 0.05
    uncond_img_ratio: float = 0.1
    uncond_audio_ratio: float = 0.05
    motion_scale: Tuple[float, float, float] = (1.0, 2.0, 3.0)
    checkpointing_steps: int = 500
    checkpoint_dir: str = "checkpoints/stage2"
    meta_paths: Sequence[str] = ()
    seed: int = 12580
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1


@dataclasses.dataclass
class Stage2ImageTrainConfig:
    """Stage-2 process-1 single-image pretrain (reference
    config/train/stage1.yaml + train_stage_1.py)."""

    train_width: int = 256
    train_height: int = 256
    sample_margin: int = 30
    batch_size: int = 4
    max_train_steps: int = 30000
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    snr_gamma: float = 5.0
    noise_offset: float = 0.05
    uncond_ratio: float = 0.1
    checkpointing_steps: int = 2000
    checkpoint_dir: str = "checkpoints/stage2_image"
    meta_paths: Sequence[str] = ()
    seed: int = 12580
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1


def load_config(cls, path: Optional[str] = None, **overrides):
    """Build a config from an optional JSON/YAML file + overrides."""
    data: Dict[str, Any] = {}
    if path:
        text = Path(path).read_text()
        if path.endswith(".json"):
            data = json.loads(text)
        else:
            import yaml

            data = yaml.safe_load(text)
    data.update(overrides)
    # nested scheduler dict
    if cls is InferenceConfig and isinstance(data.get("scheduler"), dict):
        data["scheduler"] = SchedulerConfig(**data["scheduler"])
    return cls(**data)
