"""Inference configuration: a copy of `SchedulerConfig`, `InferenceConfig`
and `load_config` from `mmgt_tpu/config.py` (the training configs wait for
the training slices). The yaml import stays lazy."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


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
