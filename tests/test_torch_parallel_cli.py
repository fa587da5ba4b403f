"""The training CLIs as torchrun starts them (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR/PORT set in each of 2 spawned gloo ranks on the
CPU) against the same CLI in one process on the same data: the image CLI
at tp = 2 (`--tiny`) and the Stage-1 CLI at dp = 2 (a tiny decoder).
Rank 0 alone writes the metrics and the checkpoint. The rank function
lives here and imports no JAX (this module imports none). Tolerances are
stated in the test."""
import os

import numpy as np
import pytest
import torch

from mmgt_tpu_torch.parallel.launch import spawn


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread in the parent, as tests/torch_port_util.py's
    fixture (not imported here: the ranks import this module, and that one
    imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _records(root, n=2, t=40, size=64):
    """Packed clip records (tests/test_torch_training_io.py's), their meta."""
    import json

    rng = np.random.default_rng(0)
    h8 = size // 8
    recs = []
    for i in range(n):
        p = os.path.join(root, f"r{i}.npz")
        np.savez(p, frames=rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
                 pose=rng.integers(0, 255, (t, size, size, 3), dtype=np.uint8),
                 face_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 lips_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 hands_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 full_mask=rng.integers(0, 255, (t, h8, h8), dtype=np.uint8),
                 audio_emb=rng.random((t, 12, 768)).astype(np.float16))
        recs.append({"record": p})
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as f:
        json.dump(recs, f)
    return meta


def _gesture_dir(root, n=5):
    rng = np.random.default_rng(1)
    for sub, d in (("keypoints", 402), ("baseline_feats", 35)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            np.save(os.path.join(root, sub, f"c{i}.npy"), rng.random((90, d)).astype(np.float32))
    return root


def _tiny_smga_build(cfg, device=None, seed=0):
    from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder
    from mmgt_tpu_torch.training.stage1 import HORIZON, SMGA

    return SMGA.build(device, seed, model=GestureDecoder(NFEATS, HORIZON, 64, 128, 2, 4, 35),
                      feature_type=cfg.feature_type)


def _cli_rank(margs, cli, argv, port):
    """One rank of `torchrun --nproc_per_node N -m <cli>`: the torchrun
    environment, then the CLI's main."""
    torch.set_num_threads(1)
    from mmgt_tpu_torch.scripts import train_a2p, train_stage2_image

    os.environ.update(RANK=str(margs["rank"]), LOCAL_RANK=str(margs["rank"]),
                      WORLD_SIZE=str(margs["world_size"]), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if cli == "train_a2p":
        train_a2p.build = _tiny_smga_build
        assert train_a2p.main(argv) == 0
    else:
        assert train_stage2_image.main(argv) == 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics(path):
    import json

    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()]


@pytest.mark.parametrize("cli,world,flags", [("train_stage2_image", 2, ["--mesh_tp", "2"]),
                                             ("train_a2p", 2, [])])
def test_cli_under_torchrun_matches_one_process(tmp_path, cli, world, flags):
    """The image CLI at tp = 2 (--tiny) and the Stage-1 CLI at dp = 2 (a
    tiny decoder), each started as torchrun starts it: rank 0 alone writes
    the metrics (each logged step once) and the final checkpoint, whose
    losses equal the one-process run's on the same data within 1e-4
    (f32 sums in another order) and whose tensors hold within 2e-4 of it
    for the image trainer (AdamW's first step moves a weight by about lr
    = 1e-5; its second, 2 lr at most) and, for Adan, by the 95 % rule
    below."""
    from mmgt_tpu_torch.scripts import train_a2p, train_stage2_image
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager

    def argv(out):
        a = ["--device", "cpu", "--checkpoint_dir", str(out)]
        if cli == "train_a2p":
            return a + ["--data_dir", gdir, "--feature_type", "baseline", "--batch_size", "2",
                        "--epochs", "1"]
        return a + ["--meta", meta, "--max_steps", "2", "--size", "64", "--batch_size", "2",
                    "--tiny"]

    gdir = _gesture_dir(str(tmp_path / "g")) if cli == "train_a2p" else None
    meta = _records(str(tmp_path)) if cli != "train_a2p" else None
    one = tmp_path / "one"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    if cli == "train_a2p":
        saved = train_a2p.build
        train_a2p.build = _tiny_smga_build
        try:
            assert train_a2p.main(argv(one)) == 0
        finally:
            train_a2p.build = saved
    else:
        assert train_stage2_image.main(argv(one)) == 0
    torch.set_num_threads(n)
    many = tmp_path / "many"
    spawn(_cli_rank, world, str(tmp_path), cli, argv(many) + flags, _free_port())
    want, got = _metrics(one / f"{cli}.jsonl"), _metrics(many / f"{cli}.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for a, b in zip(got, want):
        _close(a["loss"], b["loss"], 1e-4, 0, f"step {a['step']}")
    m1, m2 = CheckpointManager(str(one)), CheckpointManager(str(many))
    assert m2.all_steps() == m1.all_steps() == [2]
    h1, _ = m1._read_header(m1.path(2))
    h2, _ = m2._read_header(m2.path(2))
    assert [(e["name"], e.get("shape")) for e in h1["entries"]] == \
        [(e["name"], e.get("shape")) for e in h2["entries"]]
    # the tensors, read back through the package's own restore
    tree1 = {e["name"]: (torch.empty(e["shape"], dtype=getattr(torch, e["dtype"]))
                         if "int" not in e else 0) for e in h1["entries"]}
    tree2 = {k: (v.clone() if torch.is_tensor(v) else 0) for k, v in tree1.items()}
    r1, r2 = m1.restore(tree1), m2.restore(tree2)
    held = total = 0
    for k, v in r1.items():
        if not torch.is_tensor(v):
            assert r2[k] == v, k
        elif cli == "train_a2p":
            # Adan: tests/test_torch_train_stage1.py's bound, 1e-6 of the
            # largest |p| + 10 % of lr, on at least 95 % of the elements
            # (where Adan's denominator is zero up to rounding its ratio is
            # unbounded, and the rounding of the dp mean decides it)
            assert torch.isfinite(r2[k].float()).all(), k
            err = (r2[k].float() - v.float()).abs()
            held += int((err <= 1e-6 * float(v.abs().max()) + 0.1 * 2e-4).sum())
            total += err.numel()
        else:
            _close(r2[k].float(), v.float(), 2e-4, 2e-4, k)
    assert held >= 0.95 * total
