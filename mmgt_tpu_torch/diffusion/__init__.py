"""The port's samplers: DDIM and DPM-Solver++(2M) for Stage 2 (`ddim.py`,
`dpm.py`, stepped by `solver.py`) and the Stage-1 gesture DDIM
(`gesture.py`)."""
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler, DDIMState
from mmgt_tpu_torch.diffusion.dpm import DPMSolverPlusPlus2M, DPMState


def make_scheduler(cfg):
    """The Stage-2 sampler of a `config.SchedulerConfig`
    (`mmgt_tpu.diffusion.make_scheduler`)."""
    common = dict(
        num_train_timesteps=cfg.num_train_timesteps, beta_start=cfg.beta_start,
        beta_end=cfg.beta_end, beta_schedule=cfg.beta_schedule,
        prediction_type=cfg.prediction_type, rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        timestep_spacing=cfg.timestep_spacing, steps_offset=cfg.steps_offset)
    solver = getattr(cfg, "solver", "ddim")
    if solver == "ddim":
        return DDIMScheduler(clip_sample=cfg.clip_sample, **common)
    if solver in ("dpm++2m", "dpm"):
        return DPMSolverPlusPlus2M(**common)
    raise ValueError(f"unknown solver: {solver!r}")
