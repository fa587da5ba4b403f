"""The Python tile plans of K3 (`fused_ln.gemm_plan`) and K4's kernel A
(`motion_attention.attn_plan`): every shape that the port's main path, its
trainer and the card's tiny pipelines hand these kernels gets a plan that
fits 227 KB of shared memory, and a shape that cannot fit raises before
any launch. The C entries check the same plan (csrc/ln_proj.cu,
csrc/motion_attn.cu), so a plan that passes here is the one the card runs."""
import pytest

from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M

SMEM = 232448  # bytes of shared memory a block may use on the H100

# full width: (320, 640, 1280, 1280), 512x512 (tokens 4096 .. 64); the card's
# tiny pipeline: (64, 128, 128, 128), 64x64 (tokens 64 .. 1); the CPU tests'
# tiny networks: (32, 64, 64, 64) and (16, 32, 32, 32)
WIDTHS = {"full": ((320, 640, 1280, 1280), (4096, 1024, 256, 64)),
          "card tiny": ((64, 128, 128, 128), (64, 16, 4, 1)),
          "test tiny": ((32, 64, 64, 64), (64, 16, 4, 1)),
          "train tiny": ((16, 32, 32, 32), (64, 16, 4, 1))}
# frame rows of a call: denoise (2 windows x CFG x 12 frames), its audio
# blocks (conditional rows only), ReferenceNet (1), training (12 frames)
ROWS = (48, 24, 12, 1)


def _k3_shapes(chans, tokens):
    for c, l in zip(chans, tokens):
        inners = {c, chans[max(0, chans.index(c) - 1)]}  # audio blocks follow the input width
        for rows in ROWS:
            m = rows * l
            for k in {c} | inners:
                yield m, k, [k, k, k]      # q/k/v, or the 3 audio q
                yield m, k, [8 * k]        # GEGLU
                yield m, k, [k]            # K4's W_o (no LayerNorm)


@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_k3_plan_fits_every_path_shape(config):
    chans, tokens = WIDTHS[config]
    for m, k, ns in _k3_shapes(chans, tokens):
        plan = L.gemm_plan(m, k, ns)
        assert plan["bm"] in (64, 128) and plan["bn"] == 160
        assert 2 <= plan["stages"] <= L.MAX_STAGES
        assert plan["smem"] == L.gemm_smem(plan["bm"], k, plan["stages"]) <= SMEM
        # one more stage would not fit: the ring is as deep as the budget allows
        if plan["stages"] < L.MAX_STAGES:
            assert L.gemm_smem(plan["bm"], k, plan["stages"] + 1) > SMEM
        assert 1 <= plan["nsplit"] <= plan["tiles"] == sum(-(-n // 160) for n in ns)


@pytest.mark.parametrize("k,bm", [(32, 128), (320, 128), (576, 128), (640, 64), (1280, 64)])
def test_k3_plan_stripe_rows(k, bm):
    """128-row stripes while two weight tiles fit beside them, else 64."""
    assert L.gemm_plan(4096, k, [k])["bm"] == bm


def test_k3_plan_splits_n_only_for_few_stripes():
    assert L.gemm_plan(48 * 4096, 320, [320] * 3)["nsplit"] == 1
    small = L.gemm_plan(24 * 256, 1280, [1280] * 3)  # 96 stripes of 64 rows
    assert small["nsplit"] * small["stripes"] >= 2 * L.SMS


@pytest.mark.parametrize("k,ns", [(1344, [64]), (2560, [2560]), (12, [64]), (320, [100]),
                                  (320, [320] * 4), (320, [])])
def test_k3_plan_raises_where_nothing_fits(k, ns):
    with pytest.raises(ValueError):
        L.gemm_plan(1000, k, ns)


def _k4_shapes(chans, tokens, heads):
    for c, l in zip(chans, tokens):
        for frames in (12, 16, 8, 2, 32):
            yield frames, l, c, heads


@pytest.mark.parametrize("config,heads", [("full", 8), ("card tiny", 2)])
def test_k4_plan_fits_every_path_shape(config, heads):
    chans, tokens = WIDTHS[config]
    for f, l, c, h in _k4_shapes(chans, tokens, heads):
        plan = M.attn_plan(f, l, c, h)
        d = c // h
        assert plan["rp"] == (128 if d <= 96 else 64)
        assert 1 <= plan["lt"] <= l and plan["lt"] * f <= plan["rp"]
        assert 2 <= plan["stages"] <= 4
        assert plan["smem"] == M.attn_smem(plan["rp"], d, plan["stages"], f, plan["lt"]) <= SMEM


def test_k4_plan_level0_two_blocks_an_sm():
    """At level 0 (d = 40, 12 frames) two blocks share an SM: 10 tokens a
    block (120 of 128 rows), three ring stages."""
    plan = M.attn_plan(12, 4096, 320, 8)
    assert (plan["rp"], plan["lt"], plan["stages"]) == (128, 10, 3)
    assert plan["smem"] <= M.TWO_BLOCKS


@pytest.mark.parametrize("f,l,c,heads", [(33, 64, 320, 8), (12, 64, 320, 7), (12, 64, 64, 8),
                                         (12, 64, 4096, 16), (12, 64, 1920, 8)])
def test_k4_plan_raises_on_shapes_it_does_not_take(f, l, c, heads):
    with pytest.raises(ValueError):
        M.attn_plan(f, l, c, heads)
