"""The training slice's host side in mmgt_tpu_torch against mmgt_tpu: the
configs, the datasets (bitwise, same files and seed), the MMR records and
the native loader, the metrics, and the port's own checkpoints (round
trip, loud mismatches, pruning, and a resumed run bitwise equal to an
uninterrupted one on the CPU), and each training CLI's `main` on tiny nets
and synthetic records.

Tolerances: none but CLIP identity drift, 1e-5 (a one-layer ViT in f32
through two packages); everything else is compared exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu import config as jconfig
from mmgt_tpu.data import datasets as jds
from mmgt_tpu.data import mmr as jmmr
from mmgt_tpu.models.clip_vision import CLIPVisionModel as JCLIP
from mmgt_tpu.utils import metrics as jmetrics
from mmgt_tpu_torch import config as pconfig
from mmgt_tpu_torch.data import datasets as pds
from mmgt_tpu_torch.data import mmr as pmmr
from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder
from mmgt_tpu_torch.scripts import train_a2p, train_stage2, train_stage2_image
from mmgt_tpu_torch.training.loop import step_generator
from mmgt_tpu_torch.training.stage1 import HORIZON, SMGA
from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer
from mmgt_tpu_torch.utils import metrics as pmetrics
from mmgt_tpu_torch.utils.checkpoint import CheckpointManager
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, load_jax_params
from torch_port_util import close, init_noised, one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["Stage1TrainConfig", "Stage2TrainConfig",
                                  "Stage2ImageTrainConfig"])
def test_training_configs_match_jax(tmp_path, name):
    """The same fields and defaults, and the same values from a JSON file
    with overrides."""
    pc, jc = getattr(pconfig, name), getattr(jconfig, name)
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"seed": 7, "learning_rate": 3e-4}))
    got = pconfig.load_config(pc, str(path), checkpoint_dir="x")
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig.load_config(jc, str(path), checkpoint_dir="x"))
    assert got.seed == 7 and got.checkpoint_dir == "x"


# ------------------------------------------------------------- datasets
def _records(tmp_path, n=3, t=40, size=32, seed=0):
    rng = np.random.default_rng(seed)
    h8 = size // 8
    recs = []
    for i in range(n):
        p = tmp_path / f"r{i}.npz"
        np.savez(p, frames=rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
                 pose=rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
                 face_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 lips_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 hands_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 full_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 audio_emb=rng.random((t, 12, 768)).astype(np.float16))
        recs.append({"record": str(p)})
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps(recs))
    return [str(meta)]


def _gesture_dir(tmp_path, n=5):
    rng = np.random.default_rng(1)
    for sub, d in (("keypoints", 402), ("baseline_feats", 35)):
        (tmp_path / sub).mkdir(parents=True)
        for i in range(n):
            np.save(tmp_path / sub / f"c{i}.npy", rng.random((90, d)).astype(np.float32))
    return str(tmp_path)


DATASETS = {  # kind -> (module, meta paths, gesture dir) -> dataset
    "gesture": lambda mod, meta, gdir: mod.GestureDataset(gdir, "baseline"),
    "talking": lambda mod, meta, gdir: mod.TalkingVideoDataset(meta, 12, 2),
    "talking_meanpool_no_audio": lambda mod, meta, gdir: mod.TalkingVideoDataset(
        meta, 8, 2, pyramid_mode="meanpool", with_audio=False, explicit_full_mask=True),
    "dance": lambda mod, meta, gdir: mod.HumanDanceDataset(meta, 10),
    "dance_video": lambda mod, meta, gdir: mod.HumanDanceVideoDataset(
        meta, 6, 4, 24, 24, img_scale=(0.7, 1.0)),
}


def _flat(batch):
    out = {}
    for k, v in batch.items():
        if k == "masks":
            out.update({f"masks/{lv}/{j}": m for lv, ms in enumerate(v) for j, m in enumerate(ms)})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("kind", list(DATASETS))
def test_dataset_batches_match_jax_bitwise(tmp_path, kind):
    args = (_records(tmp_path), _gesture_dir(tmp_path / "g"))
    pit = DATASETS[kind](pds, *args).batches(2, seed=3)
    jit = DATASETS[kind](jds, *args).batches(2, seed=3)
    for _ in range(4):
        got, want = _flat(next(pit)), _flat(next(jit))
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (kind, k)


@pytest.mark.parametrize("kind", list(DATASETS))
def test_dataset_batches_depend_on_seed(tmp_path, kind):
    ds = DATASETS[kind](pds, _records(tmp_path), _gesture_dir(tmp_path / "g"))
    a, b = _flat(next(ds.batches(2, seed=1))), _flat(next(ds.batches(2, seed=2)))
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_resize_helpers_match_jax():
    rng = np.random.default_rng(2)
    m = rng.random((3, 16, 16))
    np.testing.assert_array_equal(pds._resize_area_bilinear(m, 8), jds._resize_area_bilinear(m, 8))
    img = rng.random((2, 20, 24, 3))
    np.testing.assert_array_equal(pds._crop_resize(img, (2, 3, 15, 18), 8, 10),
                                  jds._crop_resize(img, (2, 3, 15, 18), 8, 10))
    for seed in range(5):
        assert pds._sample_crop_box(np.random.default_rng(seed), 20, 24, (0.5, 1.0)) == \
            jds._sample_crop_box(np.random.default_rng(seed), 20, 24, (0.5, 1.0))
    assert pds.VIS_THRESH == jds.VIS_THRESH


# ------------------------------------------------------------- MMR records
def _mmr_fields(t=40, size=16):
    rng = np.random.default_rng(0)
    return {"frames": rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
            "pose": rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
            "face_mask": rng.integers(0, 255, (t, 8, 8), dtype=np.uint8),
            "lips_mask": rng.integers(0, 255, (t, 8, 8), dtype=np.uint8),
            "hands_mask": np.zeros((t, 8, 8), np.uint8),
            "audio_emb": rng.random((t, 12, 32)).astype(np.float16),
            "ids": np.arange(t, dtype=np.int64), "w": rng.random(5).astype(np.float32)}


def test_mmr_round_trip_and_files_match_jax(tmp_path):
    fields = _mmr_fields()
    pmmr.write_mmr(str(tmp_path / "p.mmr"), fields)
    jmmr.write_mmr(str(tmp_path / "j.mmr"), fields)
    assert (tmp_path / "p.mmr").read_bytes() == (tmp_path / "j.mmr").read_bytes()
    for reader in (pmmr.read_mmr, jmmr.read_mmr):
        back = reader(str(tmp_path / "p.mmr"))
        assert set(back) == set(fields)
        for k in fields:
            assert back[k].dtype == fields[k].dtype
            np.testing.assert_array_equal(back[k], fields[k])


def test_native_loader_builds_into_the_port_and_samples(tmp_path):
    lib = pmmr.build_native()
    assert lib is not None, "g++ could not build csrc/mmr_loader.cpp"
    assert lib.parent == pmmr._LIB_DIR and lib.parent.name == "_build"
    assert lib.parent.parent.name == "mmgt_tpu_torch"
    paths, all_fields = [], []
    for i in range(2):
        p = tmp_path / f"r{i}.mmr"
        f = _mmr_fields()
        f = {k: v for k, v in f.items() if k not in ("ids", "w")}
        f["frames"] = (f["frames"] + i).astype(np.uint8)
        pmmr.write_mmr(str(p), f)
        paths.append(str(p))
        all_fields.append(f)
    loader = pmmr.NativeWindowLoader(paths, n_frames=12, margin=2, seed=7, n_workers=2)
    try:
        for _ in range(12):
            s = loader.next()
            start, clip = int(s["_start"]), int(s["_clip"])
            assert s["frames"].shape == (12, 16, 16, 3)
            assert s["frames_ref"].shape == (16, 16, 3)
            for k in ("frames", "face_mask", "audio_emb"):
                np.testing.assert_array_equal(s[k], all_fields[clip][k][start:start + 12])
    finally:
        loader.close()


def test_native_loader_build_path_imports_no_jax_or_mmgt_tpu():
    code = ("import sys; from mmgt_tpu_torch.data.mmr import build_native; "
            "lib = build_native(); assert lib is not None; "
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mmgt_tpu')); assert not bad, bad; print(lib)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mmgt_tpu_torch/_build/libmmr_loader-" in out.stdout


# ------------------------------------------------------------- metrics
def test_quality_metrics_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (4, 40, 48, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    for fn in ("psnr", "ssim"):
        assert getattr(pmetrics, fn)(a, b) == getattr(jmetrics, fn)(a, b)
    assert pmetrics.psnr(a, a) == float("inf")
    assert pmetrics.temporal_flicker(b) == jmetrics.temporal_flicker(b)
    assert pmetrics.temporal_flicker(b[:1]) == 0.0


def test_clip_identity_drift_matches_jax():
    rng = np.random.default_rng(5)
    fa = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    fb = np.clip(fa + rng.normal(0, 0.2, fa.shape), 0, 1).astype(np.float32)
    kw = dict(hidden_dim=32, num_layers=1, heads=4, patch=32, image_size=224, proj_dim=16)
    jm = JCLIP(**kw)
    params = init_noised(jm, jnp.zeros((1, 224, 224, 3)), seed=6)
    pm = load_jax_params(CLIPVisionModel(**kw), params, ENCODER_MAPPERS["clip"]).eval()
    got = pmetrics.clip_identity_drift(fa, fb, pm, batch=2)
    want = jmetrics.clip_identity_drift(fa, fb, jm, params, batch=2)
    close(got, want, rtol=0, atol=1e-5)
    assert got > 0 and abs(pmetrics.clip_identity_drift(fa, fa, pm)) < 1e-6


def test_metrics_logger_writes_what_jax_writes(tmp_path):
    recs = []
    for mod, sub in ((pmetrics, "p"), (jmetrics, "j")):
        log = mod.MetricsLogger(str(tmp_path / sub), "m", echo_every=100)
        log.log(1, {"loss": torch.tensor(0.5) if mod is pmetrics else 0.5, "tag": "a"})
        log.log(100, {"loss": 0.25}, echo=False)
        log.close()
        recs.append([{k: v for k, v in json.loads(x).items() if k != "time"}
                     for x in (tmp_path / sub / "m.jsonl").read_text().splitlines()])
    assert recs[0] == recs[1] == [{"step": 1, "loss": 0.5, "tag": "a"},
                                  {"step": 100, "loss": 0.25}]


# ------------------------------------------------------------- checkpoints
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"step": 3, "a/w": torch.randn(4, 5, generator=g),
            "a/b": torch.randn(7, generator=g).to(torch.bfloat16),
            "opt/step": torch.tensor(2.0), "ids": torch.arange(6), "empty": torch.zeros(0, 3)}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    src = _tree(0)
    path = mgr.save(3, src)
    assert path.name == "ckpt-3.ckpt" and mgr.latest_step() == 3
    dst = _tree(1)
    keep = {k: v for k, v in dst.items() if isinstance(v, torch.Tensor)}
    dst["step"] = 0
    got = mgr.restore(dst)
    assert got["step"] == 3
    for k, v in keep.items():
        assert got[k] is v  # in place
        assert v.dtype == src[k].dtype and torch.equal(v, src[k]), k


def test_checkpoint_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    t = _tree()
    t["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="mismatch"):
        mgr.restore(t)
    t = _tree()
    del t["a/w"]
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(t)
    for bad in (torch.zeros(5, 4), torch.zeros(4, 5, dtype=torch.float64), 0):
        t = _tree()
        t["a/w"] = bad
        with pytest.raises(ValueError, match="layout mismatch"):
            mgr.restore(t)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(_tree())


def test_checkpoint_pruning_keeps_max_to_keep_and_keep_period(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), max_to_keep=2)
    for s in range(1, 6):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.all_steps() == [4, 5]
    mgr = CheckpointManager(str(tmp_path / "b"), max_to_keep=2, keep_period=2)
    for s in range(1, 8):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.all_steps() == [2, 4, 6, 7]
    out = {"x": torch.zeros(2)}
    mgr.restore(out, 4)
    assert out["x"].tolist() == [4.0, 4.0]
    assert not list((tmp_path / "b").glob("*.tmp"))


def _image_run(tmp_path, seed, steps, restore_from=None):
    pipe = train_stage2_image.tiny_pipeline("cpu", seed=seed)
    trainer = Stage2ImageTrainer(pipe, uncond_ratio=0.5)
    state = trainer.init_state()
    if restore_from is not None:
        assert trainer.restore(state, restore_from) == 2
    rng = np.random.default_rng(9)
    batches = [{"tgt_image": torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)), "ref_image": torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
            np.float32)), "tgt_pose": torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(
                np.float32)), "clip_embed": torch.from_numpy(rng.standard_normal(
                    (2, 1, 768)).astype(np.float32))} for _ in range(3)]
    while state.step < steps:
        trainer.train_step(state, batches[state.step],
                           generator=step_generator("cpu", 0, state.step))
    return trainer, state


def _smga_run(seed, steps, restore_from=None):
    smga = SMGA.build("cpu", seed, model=GestureDecoder(NFEATS, HORIZON, 64, 128, 2, 4, 35),
                      feature_type="baseline")
    state = smga.init_state()
    if restore_from is not None:
        assert smga.restore(state, restore_from) == 2
    rng = np.random.default_rng(10)
    batches = [{"keypoints": torch.from_numpy(rng.uniform(0, 1, (4, 80, 402)).astype(np.float32)),
                "cond_frame": torch.from_numpy(rng.uniform(0, 1, (4, 402)).astype(np.float32)),
                "audio_features": torch.from_numpy(rng.standard_normal((4, 80, 35)).astype(
                    np.float32))} for _ in range(3)]
    while state.step < steps:
        smga.train_step(state, batches[state.step], generator=step_generator("cpu", 0, state.step))
    return smga, state


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("which", ["image_trainer", "smga"])
def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path, which):
    """2 steps, save, restore into a fresh state of other seeded weights,
    1 step == 3 steps without a break: every tensor of the state (weights,
    f32 masters, AdamW's or Adan's buffers, the EMA, the frozen weights)."""
    mgr = CheckpointManager(str(tmp_path))
    if which == "image_trainer":
        run = lambda seed, steps, restore=None: _image_run(tmp_path, seed, steps, restore)
    else:
        run = _smga_run
    whole, whole_state = run(0, 3)
    part, part_state = run(0, 2)
    mgr.save(part_state.step, part.checkpoint_tree(part_state))
    resumed, resumed_state = run(1, 3, mgr)
    assert resumed_state.step == whole_state.step == 3
    _assert_trees_equal(resumed.checkpoint_tree(resumed_state), whole.checkpoint_tree(whole_state))
    _, other = run(1, 3)  # the other weights do differ
    assert not torch.equal(next(iter(other.ema.values() if which == "smga" else
                                     other.masters.values())),
                           next(iter(whole_state.ema.values() if which == "smga" else
                                     whole_state.masters.values())))


# ------------------------------------------------------------- CLIs
def _tiny_video_build(cfg, device=None, seed=0, weights_dir=None):
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer
    from test_torch_train import _port_pipeline

    return Stage2Trainer(_port_pipeline(), learning_rate=cfg.learning_rate), None


def _tiny_smga_build(cfg, device=None, seed=0):
    return SMGA.build(device, seed, model=GestureDecoder(NFEATS, HORIZON, 64, 128, 2, 4, 35),
                      feature_type=cfg.feature_type)


@pytest.mark.parametrize("cli", ["train_stage2_image", "train_stage2", "train_a2p"])
def test_cli_main_runs_two_steps_and_writes_checkpoint_and_metrics(tmp_path, cli, monkeypatch):
    """On tiny nets: the image CLI's own --tiny, a tiny build for the
    others."""
    out = tmp_path / "ckpt"
    argv = ["--device", "cpu", "--checkpoint_dir", str(out)]
    if cli == "train_a2p":
        argv += ["--data_dir", _gesture_dir(tmp_path / "g"), "--feature_type", "baseline",
                 "--batch_size", "2", "--epochs", "1"]  # 5 clips: 2 steps an epoch
        monkeypatch.setattr(train_a2p, "build", _tiny_smga_build)
        main = train_a2p.main
    else:
        argv += ["--meta", *_records(tmp_path, n=2, t=40, size=64), "--max_steps", "2",
                 "--size", "64"]
        if cli == "train_stage2_image":
            argv += ["--batch_size", "2", "--tiny"]
            main = train_stage2_image.main
        else:
            monkeypatch.setattr(train_stage2, "build", _tiny_video_build)
            main = train_stage2.main
    assert main(argv) == 0
    assert CheckpointManager(str(out)).all_steps() == [2]
    recs = [json.loads(x) for x in (out / f"{cli}.jsonl").read_text().splitlines()]
    assert recs[0]["step"] == 1 and np.isfinite(recs[0]["loss"])
