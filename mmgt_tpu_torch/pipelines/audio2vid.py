"""Audio2Video orchestrator (`mmgt_tpu/pipelines/audio2vid.py`): audio +
portrait -> gesturing video, on the card.

  1. slice the audio into 3.2 s windows (inputs over 3.3 s);
  2. Stage 1: per slice, WavLM + baseline features -> SMGA DDIM sampling;
     the slices chain through the last frame, and with motion selection
     each slice samples several candidates and keeps the one whose start
     best continues the previous slice (chosen on the device);
  3. cubic-spline smoothing at the slice seams (host);
  4. keypoints -> rasterized pose video and mask pyramids (device);
  5. Stage 2: wav2vec2 audio embeddings and the CLIP reference embedding
     -> `Pose2VideoPipeline`, then the VAE decode.

`__call__` records the seconds of each phase in `timings` (stage1_s,
conditioning_s, audio_clip_s, stage2_s, and the Stage-2 pipeline's own
stage2_* phases when it profiles them), each ending in a device
synchronise, and the kernel launches of each phase in `phase_launches`.
The JAX package's `_combine_cond_chunks` works around a TPU transport;
here the conditioning chunks are joined with `torch.cat`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from mmgt_tpu_torch.config import InferenceConfig
from mmgt_tpu_torch.data.audio import (
    SAMPLE_RATE,
    AudioProcessor,
    WavLMFeatureExtractor,
    slice_audio,
    stage1_condition,
)
from mmgt_tpu_torch.data.conditioning import (
    denormalize_keypoints,
    mask_leg,
    normalize_keypoints,
    prepare_conditioning_from_keypoints,
)
from mmgt_tpu_torch.data.dsp import load_wav
from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.diffusion import make_scheduler
from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel, clip_preprocess
from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from mmgt_tpu_torch.models.wavlm import WavLMModel
from mmgt_tpu_torch.ops import launch_counts
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline, init_random_params
from mmgt_tpu_torch.training.stage1 import SMGA

HORIZON = 80  # frames per 3.2 s slice


def candidate_scores(batch: torch.Tensor, prev6: torch.Tensor) -> torch.Tensor:
    """The continuity score of each candidate against the previous slice
    (position L1 + mean velocity-angle score, audio2vid.py:79-108), on the
    device.

    batch (n_cand, T, 402); prev6 (6, 402), the previous slice's last six
    frames. Returns (n_cand,) scores; lower is better."""
    last_pos = prev6[1:]
    last_v = (prev6[1:] - prev6[:-1]).mean(0).reshape(-1, 2) * 1000.0
    cand_v = ((batch[:, 1:] - batch[:, :-1])[:, -5:].mean(1)
              .reshape(batch.shape[0], -1, 2) * 1000.0)
    pos = (batch[:, :5] - last_pos[None]).abs().sum((1, 2))
    dots = (cand_v * last_v[None]).sum(-1)
    norms = torch.linalg.norm(cand_v, dim=-1) * torch.linalg.norm(last_v, dim=-1)[None]
    cos = torch.clamp(dots / torch.clamp(norms, min=1e-8), -1.0, 1.0)
    return pos + torch.arccos(cos).mean(-1)


def find_best_slice(candidates: List[np.ndarray], prev: np.ndarray) -> np.ndarray:
    """The candidate whose start best continues the previous slice: the
    first of the lowest `candidate_scores`."""
    scores = candidate_scores(torch.from_numpy(np.stack(candidates)),
                              torch.from_numpy(np.asarray(prev[-6:])))
    return candidates[int(torch.argmin(scores))]


def smooth_seams(seq: np.ndarray, seam_spacing: int = HORIZON, halfwin: int = 5) -> np.ndarray:
    """Cubic-spline interpolation across slice seams (audio2vid.py:361-374)."""
    out = seq.copy()
    t = len(seq)
    for point in range(seam_spacing, t, seam_spacing):
        lo, hi = max(0, point - halfwin), min(t, point + halfwin)
        x = list(range(max(0, lo - 3), lo)) + list(range(hi, min(t, hi + 3)))
        if len(x) < 4 or lo - 2 < 0 or hi + 2 > t:
            continue
        cs = CubicSpline(x, out[x], axis=0)
        xx = np.arange(lo - 2, hi + 2)
        out[lo - 2 : hi + 2] = cs(xx)
    return out


def _on(model, dev, dtype, gen):
    """A model built on the meta device, materialised on `dev` in `dtype`
    with seeded random weights."""
    model.to_empty(device=dev)
    return init_random_params(model.to(dtype), gen)


@dataclasses.dataclass(eq=False)
class Audio2VideoPipeline:
    smga: SMGA
    pose2vid: Pose2VideoPipeline
    clip_model: Optional[CLIPVisionModel] = None
    audio_processor: Optional[AudioProcessor] = None
    wavlm_extractor: Optional[WavLMFeatureExtractor] = None
    config: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    # frames rasterized at once: the conditioning is per frame, so a long
    # clip runs in slices of this many frames (bounds the canvas's memory)
    raster_chunk: int = HORIZON

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, feature_type: str = "wavlm",
              seed: int = 0, config: Optional[InferenceConfig] = None,
              **pose2vid_kwargs) -> "Audio2VideoPipeline":
        """Every model at full width on `device` (the card unless the caller
        asks for the CPU), seeded random weights: Stage 2 and CLIP ViT-L/14
        in `dtype`; wav2vec2-base, WavLM Large and the SMGA decoder in f32
        (the dtypes `mmgt_tpu/utils/weights.py` gives them)."""
        cfg = config or InferenceConfig(a2p_feature_type=feature_type)
        dev = resolve_device(device)
        pose2vid = Pose2VideoPipeline.build(
            dtype, dev, seed, scheduler=make_scheduler(cfg.scheduler),
            context_size=cfg.context_size, context_overlap=cfg.context_overlap,
            window_microbatch=cfg.window_microbatch, **pose2vid_kwargs)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        with torch.device("meta"):
            clip, w2v = CLIPVisionModel(), Wav2Vec2Model()
            wavlm = WavLMModel() if feature_type == "wavlm" else None
            smga = SMGA(feature_type=feature_type, guidance_weight=cfg.a2p_guidance_weight)
        f32 = torch.float32
        _on(smga.model, dev, f32, gen)
        return cls(
            smga=smga, pose2vid=pose2vid, clip_model=_on(clip, dev, dtype, gen),
            audio_processor=AudioProcessor(_on(w2v, dev, f32, gen), fps=cfg.fps),
            wavlm_extractor=(WavLMFeatureExtractor(_on(wavlm, dev, f32, gen))
                             if wavlm is not None else None),
            config=cfg)

    @property
    def device(self) -> torch.device:
        return self.pose2vid.device

    # ------------------------------------------------------------ Stage 1
    @torch.no_grad()
    def generate_pose(self, wav: np.ndarray, init_keypoints: np.ndarray,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None) -> np.ndarray:
        """Audio -> (T, 402) absolute-coordinate keypoints.

        The slices run one after another, each on its predecessor's last
        frame; with motion selection, each slice after the first samples
        `motion_candidates` poses and the device keeps the best by
        `candidate_scores` (the first slice takes candidate 0, as the
        reference samples one there). `draws`: one {"x", "noise"} a slice
        (`GestureDiffusionSchedule.draws` for (n_cand, 80, 402)), else drawn
        from `generator`. One host fetch at the end."""
        cfg = self.config
        slices = slice_audio(wav) if len(wav) / SAMPLE_RATE > 3.3 else [wav]
        init_norm = mask_leg(normalize_keypoints(
            torch.tensor(np.asarray(init_keypoints, np.float32)))).numpy()
        # the SMGA model's own feature type sets its condition's width
        conds = [stage1_condition(sl, self.wavlm_extractor, self.smga.feature_type)
                 for sl in slices]
        n_cand = cfg.motion_candidates if cfg.use_motion_selection else 1
        dev = self.smga.device
        prev6 = torch.from_numpy(init_norm).to(dev)[None].repeat(6, 1)
        chosen = []
        for i, cond in enumerate(conds):
            c = torch.from_numpy(cond).to(dev)[None].expand(n_cand, -1, -1)
            batch = self.smga.sample(prev6[-1][None].expand(n_cand, -1), c,
                                     cfg.a2p_sampling_steps, generator=generator,
                                     draws=None if draws is None else draws[i])
            pick = batch[0] if (n_cand == 1 or i == 0) else \
                batch[torch.argmin(candidate_scores(batch, prev6))]
            prev6 = pick[-6:]
            chosen.append(pick)
        seq = torch.cat(chosen).float().cpu().numpy()
        # prepend the portrait pose, drop the final frame (audio2vid.py:356-360)
        seq = np.concatenate([init_norm.reshape(1, -1), seq[:-1]], axis=0)
        return denormalize_keypoints(smooth_seams(seq, seam_spacing=HORIZON))

    def _prepare_cond_chunked(self, keypoints: torch.Tensor) -> Dict:
        """(T, 402) keypoints -> conditioning, rasterized `raster_chunk`
        frames at a time (exact: every step is per frame)."""
        cfg, k = self.config, self.raster_chunk
        parts = [prepare_conditioning_from_keypoints(keypoints[o:o + k], cfg.height, cfg.width)
                 for o in range(0, keypoints.shape[0], k)]
        if len(parts) == 1:
            return parts[0]
        return {
            "pose_video": torch.cat([p["pose_video"] for p in parts], 1),
            "masks": [tuple(torch.cat([p["masks"][lv][j] for p in parts], 1) for j in range(3))
                      for lv in range(len(parts[0]["masks"]))],
            "mask_videos": {name: torch.cat([p["mask_videos"][name] for p in parts], 0)
                            for name in parts[0]["mask_videos"]},
        }

    def _phase(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[f"{name}_s"] = time.perf_counter() - t0
        counts = launch_counts()
        self.phase_launches[name] = {k: n - self._launches_at[k] for k, n in counts.items()}
        self._launches_at = counts
        return time.perf_counter()

    # -------------------------------------------------------- full path
    @torch.no_grad()
    def __call__(self, wav_path: str, ref_image: np.ndarray, init_keypoints: np.ndarray,
                 video_length: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None) -> Dict:
        """wav file + portrait (H, W, 3) in [0, 1] + its (402,) keypoints ->
        {"frames": (T, H, W, 3) f32 numpy in [0, 1], "keypoints": (T, 402)
        numpy, "pose_video": (T, H, W, 3) on the device}. `draws`:
        {"pose": per-slice Stage-1 draws, "latents": Stage 2's initial
        noise}; whatever is absent is drawn from `generator`."""
        cfg, dev, draws = self.config, self.device, draws or {}
        wav = load_wav(wav_path, SAMPLE_RATE)
        self.timings: Dict[str, float] = {}
        self.phase_launches: Dict[str, Dict[str, int]] = {}
        self._launches_at = launch_counts()
        t0 = time.perf_counter()
        keypoints = self.generate_pose(wav, init_keypoints, generator, draws.get("pose"))
        t0 = self._phase("stage1", t0)
        length = min(len(keypoints), video_length or cfg.video_length)
        keypoints = keypoints[:length]

        cond = self._prepare_cond_chunked(torch.from_numpy(keypoints).to(dev))
        t0 = self._phase("conditioning", t0)

        if self.audio_processor is not None:
            audio_embeds, _ = self.audio_processor.preprocess(wav_path, clip_length=length)
            audio_embeds = audio_embeds[:, :length]
        else:
            audio_embeds = torch.zeros((1, length, 5, 12, 768), device=dev)
        ref = torch.from_numpy(np.asarray(ref_image, np.float32))[None].to(dev)
        if self.clip_model is not None:
            clip_embed = self.clip_model(clip_preprocess(ref))
        else:
            clip_embed = torch.zeros((1, 1, 768), device=dev)
        t0 = self._phase("audio_clip", t0)

        frames = self.pose2vid(
            ref * 2.0 - 1.0, cond["pose_video"], clip_embed, cond["masks"], audio_embeds,
            num_inference_steps=cfg.num_inference_steps, guidance_scale=cfg.guidance_scale,
            motion_scale=cfg.motion_scale, generator=generator, latents=draws.get("latents"))
        frames = frames[0].float().cpu().numpy()
        self._phase("stage2", t0)
        for k, v in getattr(self.pose2vid, "timings", {}).items():
            self.timings[f"stage2_{k}"] = v
        return {"frames": frames, "keypoints": keypoints, "pose_video": cond["pose_video"][0]}
