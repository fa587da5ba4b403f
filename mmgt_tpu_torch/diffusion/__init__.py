"""The port's samplers: DDIM for Stage 2 (`ddim.py`, stepped by
`solver.py`) and the Stage-1 gesture DDIM (`gesture.py`)."""
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler


def make_scheduler(cfg) -> DDIMScheduler:
    """The Stage-2 sampler of a `config.SchedulerConfig`
    (`mmgt_tpu.diffusion.make_scheduler`). DPM++(2M) is not ported yet."""
    if getattr(cfg, "solver", "ddim") != "ddim":
        raise NotImplementedError(f"solver {cfg.solver!r}: the port has DDIM only")
    if cfg.clip_sample:
        raise NotImplementedError("the port's DDIM does not clip samples")
    return DDIMScheduler(
        num_train_timesteps=cfg.num_train_timesteps, beta_start=cfg.beta_start,
        beta_end=cfg.beta_end, beta_schedule=cfg.beta_schedule,
        prediction_type=cfg.prediction_type, rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        timestep_spacing=cfg.timestep_spacing, steps_offset=cfg.steps_offset)
