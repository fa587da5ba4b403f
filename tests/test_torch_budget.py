"""The n-card budget tool (`mmgt_tpu_torch/tools/budget_8chip.py`) on the CPU,
at the drills' tiny Stage-2 widths: 4 gloo ranks at (dp 4, tp 1), 16
frames of 64^2 in windows of 6 overlapping by 2 (4 windows, one a rank),
one denoise step, f32.

  * shard shapes: each rank's conv_in saw 2 x 1 x 6 = 12 frame rows;
  * collectives: `STATS` over the step equals the closed form, one
    all_reduce of (2, 4, 6, 8, 8, 4) f32, 49,152 bytes;
  * equality: every rank's latents bitwise equal to one process's run at
    one window a UNet call;
  * the control: the same ranks with rank 1's window shifted by one frame
    fail the equality check, and only it;
  * the budget's arithmetic from given figures, and the windows a rank
    denoises in a flagship step at n ranks.
"""
import os

import pytest
import torch

from mmgt_tpu_torch.tools import budget_8chip as B

LAYOUT = B.default_layout(devices=4, device="cpu", frames=16, size=64, context_size=6,
                          context_overlap=2, tiny=True, timeout_s=120)


def _rank(margs, layout, out_dir):
    """The tool's rank, then the control: rank 1 denoises its window shifted
    by one frame."""
    from mmgt_tpu_torch.parallel.mesh import destroy

    torch.set_num_threads(1)
    ctx = B.rank_setup(margs, layout)
    win = B.windows(layout)
    good = B.rank_step(ctx, win, layout)
    if ctx["mesh"].dp_rank == 1:
        win = win.copy()
        win[0, 1] = (win[0, 1] + 1) % layout["frames"]
    bad = B.rank_step(ctx, win, layout)
    r = ctx["mesh"].rank
    torch.save(good, os.path.join(out_dir, f"rank{r}.pt"))
    torch.save(bad, os.path.join(out_dir, f"control{r}.pt"))
    destroy(ctx["mesh"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("budget"))
    results, ref, fails = B.run(LAYOUT, rank_fn=_rank, store=store)
    control = [torch.load(os.path.join(store, f"control{r}.pt")) for r in range(4)]
    return results, ref, fails, control


def test_shard_shapes(ranks):
    results, _, fails, _ = ranks
    assert not fails, fails
    for res in results:
        assert len(res["shapes"]) == 1, res["shapes"]
        (shp_in, shp_out), = res["shapes"]
        assert shp_in == (12, 8, 8, 4) and shp_out == (12, 8, 8, 16)


def test_collectives_equal_the_closed_form(ranks):
    results, _, _, _ = ranks
    cf = B.gather_closed_form(LAYOUT)
    assert (cf["calls"], cf["bytes"], cf["mb_l"]) == (1, 2 * 4 * 6 * 8 * 8 * 4 * 4, 1)
    assert cf["bytes"] == 49152
    for res in results:
        assert res["stats"] == {"calls": 1, "bytes": 49152}


def test_latents_bitwise_equal_one_process(ranks):
    results, ref, _, _ = ranks
    assert ref.shape == (16, 8, 8, 4) and bool(torch.isfinite(ref).all())
    for res in results:
        assert torch.equal(res["latents"], ref), res["rank"]


def test_shifted_window_fails_the_equality_check(ranks):
    _, ref, _, control = ranks
    fails = B.check(control, ref, LAYOUT)
    assert fails and all("latents differ" in f for f in fails), fails
    assert len(fails) == 4


@pytest.mark.parametrize("n,want", [(1, 10), (2, 6), (4, 4), (5, 2), (8, 2), (10, 2)])
def test_flagship_windows_per_rank(n, want):
    # 10 windows in 2 groups of 5; a group's windows split over n ranks
    assert B.flagship_windows_per_rank(n) == want


def test_budget_arithmetic():
    layout = B.default_layout()
    stats = {"calls": 1, "bytes": 524288}
    timings = {"stage1_s": 4.0, "conditioning_s": 0.3, "audio_clip_s": 0.2, "stage2_s": 5.0,
               "stage2_prepare_s": 0.25, "stage2_denoise_s": 3.7, "stage2_decode_s": 0.8}
    out = B.budget(8, stats, layout, 0.12, timings, link_gbps=450.0)
    scale = (80 * 64 * 64) / (32 * 16 * 16)
    assert scale == 40.0
    assert out["collective_bytes_per_step_flagship"] == 524288 * 40
    coll = 2 * 524288 * 40 * 7 / 8 / 450e9
    assert out["collective_s_per_step_flagship"] == pytest.approx(coll)
    assert out["windows_per_rank"] == 2
    assert out["per_step_s"] == pytest.approx(0.24 + coll)
    host = 0.3 + 0.2 + 0.25 + (5.0 - 0.25 - 3.7 - 0.8)
    assert out["host_s"] == pytest.approx(host)
    assert out["vae_s"] == pytest.approx(0.1)
    assert out["e2e_25steps_s"] == pytest.approx(25 * (0.24 + coll) + 0.1 + 4.0 + host)
    assert out["e2e_15steps_s"] == pytest.approx(15 * (0.24 + coll) + 0.1 + 4.0 + host)
    assert "specification" in out["link_source"]
    assert "per_step_s" not in B.budget(8, stats, layout, None)
