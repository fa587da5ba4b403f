"""The Python plans of K2 (`norms.gn_plan`), K3 (`fused_ln.gemm_plan`),
K4 (`motion_attention.attn_plan`) and K1's key split at d = 512
(`attention.wide_splits`): every shape that the port's
main path, its trainer and the card's tiny pipelines hand these kernels
gets a plan that fits 227 KB of shared memory, and a shape that cannot fit
raises before any launch. The C entries check the same plan
(csrc/group_norm.cu, csrc/ln_proj.cu, csrc/motion_attn.cu), so a plan that
passes here is the one the card runs."""
import itertools
import math

import pytest
import torch

from mmgt_tpu_torch.models.unet3d import skip_channels
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M
from mmgt_tpu_torch.ops import norms as N

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
    for (m, k, ns), bias in itertools.product(_k3_shapes(chans, tokens), (False, True)):
        plan = L.gemm_plan(m, k, ns, bias)
        assert plan["bm"] == 128 and plan["stripes"] == -(-m // 128)
        assert 2 <= plan["stages"] <= L.MAX_STAGES
        # the stripe keeps an f32 table of the biases, tile-padded, beside its ring
        table = 4 * plan["cols"] if bias and plan["regime"] == "stripe" else 0
        assert plan["smem"] == L.gemm_smem(plan["regime"], k, plan["stages"]) + table <= SMEM
        # persistent blocks, one an SM at most
        assert 1 <= plan["blocks"] <= L.SMS
        if plan["regime"] == "stripe":
            # (stripe, N split) items; the ring as deep as the budget allows
            assert k <= 320 and plan["bn"] == 80
            if plan["stages"] < L.MAX_STAGES:
                assert L.gemm_smem("stripe", k, plan["stages"] + 1) + table > SMEM
            assert 1 <= plan["split"] <= plan["tiles"] == sum(-(-n // plan["bn"]) for n in ns)
            assert plan["items"] == plan["stripes"] * plan["split"]
            assert plan["blocks"] == min(plan["items"], L.SMS)
            assert plan["cols"] == plan["bn"] * plan["tiles"]
        else:
            # 128 x 256 tiles of two 128-column units, one persistent block an SM
            assert k > 320 and plan["bn"] == 256 and plan["stages"] == L.TILED_STAGES
            assert L.gemm_smem("tiled", k, plan["stages"] + 1) > SMEM
            assert plan["units"] == sum(-(-n // 128) for n in ns)
            assert plan["tiles"] == plan["stripes"] * -(-plan["units"] // 2)
            assert plan["split"] == 1 and plan["blocks"] == min(plan["tiles"], L.SMS)
            assert plan["cols"] == 256 * -(-plan["units"] // 2)


@pytest.mark.parametrize("k,bm", [(32, 128), (320, 128), (576, 128), (640, 128), (1280, 128)])
def test_k3_plan_stripe_rows(k, bm):
    """128 rows a block in both regimes: a stripe held as register A
    fragments (K <= 320, every level-0 width), else a 128 x 256 tile
    streamed (576: no path shape has K between 320 and 640)."""
    plan = L.gemm_plan(4096, k, [k])
    assert plan["bm"] == bm
    assert plan["regime"] == ("stripe" if k <= 320 else "tiled")


def test_k3_plan_splits_n_only_for_few_stripes():
    big = L.gemm_plan(48 * 4096, 320, [320] * 3)
    assert big["split"] == 1 and big["blocks"] == L.SMS
    small = L.gemm_plan(2 * 4096, 320, [320] * 3)  # pose2img: 64 stripes
    # the N splits fill the card with one item a block, and no more
    assert small["stripes"] * small["split"] == small["items"] == small["blocks"]
    assert L.SMS - small["stripes"] < small["items"] <= L.SMS
    # the tiled regime runs one block an SM, or one a tile where there are fewer
    assert L.gemm_plan(24 * 256, 1280, [1280] * 3)["blocks"] == L.SMS
    assert L.gemm_plan(48 * 64, 1280, [1280])["blocks"] == 24 * 5


@pytest.mark.parametrize("k,ns", [(12, [64]), (320, [100]), (320, [320] * 4), (320, [])])
def test_k3_plan_raises_where_nothing_fits(k, ns):
    with pytest.raises(ValueError):
        L.gemm_plan(1000, k, ns)


@pytest.mark.parametrize("g_dt,b_dt", [(torch.float16, torch.float16),
                                       (torch.bfloat16, torch.float32)])
def test_k3_raises_on_other_parameter_dtypes(g_dt, b_dt):
    """gamma and beta are read as they are, bf16 or f32 of one dtype; any
    other raises before a launch (no cast on the host path)."""
    x, w = torch.zeros(256, 320, dtype=torch.bfloat16), torch.zeros(320, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gamma and beta"):
        L.ln_gemm(x, torch.ones(320, dtype=g_dt), torch.zeros(320, dtype=b_dt), [w], [None])


@pytest.mark.parametrize("k,ns", [(1344, [64]), (2560, [2560])])
def test_k3_plan_tiles_any_k(k, ns):
    """K past what a resident stripe could hold (formerly raised): the tiled
    regime streams it in 64-column chunks at the same shared memory."""
    plan = L.gemm_plan(1000, k, ns)
    assert plan["regime"] == "tiled" and plan["smem"] == L.gemm_smem("tiled", 640, 4) <= SMEM


def _k4_shapes(chans, tokens, heads):
    for c, l in zip(chans, tokens):
        for frames in (12, 16, 8, 2, 32):
            yield frames, l, c, heads


def _k4_regime(c, d):
    return "fused" if c <= 320 and d <= 64 else "cluster" if d in (80, 128, 160) else "heads"


def _check_k4_plan(plan, f, l, c, h, batch, inner=None):
    """A plan of any regime: fits 227 KB; the fused regime's halves hold
    whole tokens (F Lh <= 64 rows) and its persistent grid is at most one
    block an SM; the cluster regime's 64-row groups hold whole tokens, its
    ring is the deepest that fits, the attention's staging aliases its last
    stages and leaves one or more to the next unit's loads, each CTA loads
    d / cs rows of a weight (a multiple of 8, so a slice starts on a
    swizzle pattern) and its units cover every token block in whole
    clusters; the per-head regime (d <= 64 or 96) has 128-row blocks.
    inner: a head shard's columns (default C)."""
    d = (inner or c) // h
    assert plan["regime"] == _k4_regime(c, d)
    if plan["regime"] == "cluster":
        assert plan["lh"] == min(64 // f, l) and plan["lh"] * f <= 64
        assert plan["groups"] == (1 if d >= 128 else 2)
        assert plan["cs"] in (2, 4) and (d // plan["cs"]) % 8 == 0
        assert plan["smem"] == M.cluster_smem(d, plan["stages"]) <= SMEM
        assert plan["stages"] >= 2 and M.cluster_smem(d, plan["stages"] + 1) > SMEM
        ring, stage = plan["stages"] * M.cluster_stage(d), M.cluster_stage(d)
        assert plan["free"] >= 1 and (plan["free"] + 1) * stage > ring - M.cluster_staging(d)
        assert plan["free"] * stage <= ring - M.cluster_staging(d)
        blocks = batch * -(-l // (plan["groups"] * plan["lh"]))
        assert plan["units"] == h * -(-blocks // plan["cs"])
        # whole clusters of cs CTAs cover each head's blocks, with fewer
        # than one cluster's CTAs past its last block (the C entry launches
        # min(units, clusters the card holds) x cs CTAs)
        assert h * blocks <= plan["units"] * plan["cs"] < h * (blocks + plan["cs"])
        return
    if plan["regime"] == "fused":
        assert plan["lh"] == min(64 // f, l) and plan["lh"] * f <= 64
        assert 2 <= plan["stages"] <= 8
        assert plan["smem"] == M.fused_smem(d, c, plan["stages"]) <= SMEM
        assert plan["stages"] == 8 or M.fused_smem(d, c, plan["stages"] + 1) > SMEM
        items = batch * -(-l // (2 * plan["lh"]))
        assert h % plan["hg"] == 0 and plan["groups"] == h // plan["hg"]
        assert plan["units"] == items * plan["groups"]
        assert plan["grid"] == min(plan["units"], M.SMS) <= 132
    else:
        assert d <= 64 or d == 96
        assert 1 <= plan["lt"] <= l and plan["lt"] * f <= 128
        assert 2 <= plan["stages"] <= 4
        assert plan["smem"] == M.attn_smem(d, plan["stages"], f, plan["lt"]) <= SMEM


@pytest.mark.parametrize("config,heads", [("full", 8), ("card tiny", 2)])
def test_k4_plan_fits_every_path_shape(config, heads):
    chans, tokens = WIDTHS[config]
    for f, l, c, h in _k4_shapes(chans, tokens, heads):
        for batch in (4, 1):
            _check_k4_plan(M.attn_plan(f, l, c, h, batch=batch), f, l, c, h, batch)


def test_k4_plan_level0_two_blocks_an_sm():
    """Level 0 (d = 40, 12 frames, the denoiser's 4 rows) ran two per-head
    blocks an SM before the fused regime; now one persistent block an SM
    (its shared memory is over half the SM's 228 KB) holds a 128-row stripe
    of 10 tokens (two halves of 5, 60 of 64 rows each), a 4-stage weight
    ring, and runs all 8 heads of its tokens: 1640 units over 132 blocks."""
    plan = M.attn_plan(12, 4096, 320, 8, batch=4)
    assert (plan["regime"], plan["lh"], plan["stages"], plan["hg"]) == ("fused", 5, 4, 8)
    assert (plan["units"], plan["grid"]) == (1640, 132)
    assert 2 * plan["smem"] > 233472 >= plan["smem"]


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_k4_plan_head_shards(tp):
    """A head shard (8 // tp heads of d = C / 8, inner = C / tp) gets the
    regime and blocks of its head dim, as the whole layer's: they depend on
    d, F, L and C only; the fused regime's heads a unit divide the shard's
    own heads."""
    for c in (320, 640, 1280):
        for f in (12, 16):
            l = 4096 // (c // 320) ** 2
            whole = M.attn_plan(f, l, c, 8, batch=4)
            shard = M.attn_plan(f, l, c, 8 // tp, c // tp, batch=4)
            keys = {"fused": ("regime", "lh", "stages", "smem"),
                    "cluster": ("regime", "cs", "lh", "groups", "stages", "smem"),
                    "heads": ("regime", "lt", "stages", "smem")}[whole["regime"]]
            for key in keys:
                assert shard[key] == whole[key], (c, f, tp, key)
            if shard["regime"] == "fused":
                assert (8 // tp) % shard["hg"] == 0 and shard["grid"] <= M.SMS
    with pytest.raises(ValueError):
        M.attn_plan(12, 64, 320, 3, 160)   # 160 columns are not 3 heads


@pytest.mark.parametrize("d", M._HEAD_DIMS)
def test_k4_plan_every_head_dim(d):
    """Every head dim K4 takes plans at 1, 12 and 32 frames, two heads and
    eight: the fused regime where C <= 320 and d <= 64, clusters at d =
    80, 128 and 160, else per head."""
    for heads in (2, 8):
        c = heads * d
        for f in (1, 12, 32):
            _check_k4_plan(M.attn_plan(f, 100, c, heads, batch=2), f, 100, c, heads, 2)


@pytest.mark.parametrize("c,tp", [(640, 1), (640, 2), (640, 4), (1280, 1), (1280, 2),
                                  (1280, 4)])
def test_k4_plan_cluster_regime(c, tp):
    """Levels 1-3 and the mid block (C = 640, 1280: d = 80, 160) and their
    tp = 2 and 4 head shards take the cluster regime at every token count
    of the path (the denoiser's 4 rows, 12 frames): d = 80 in clusters of 2
    with two 64-row groups a CTA (10 tokens), d = 160 in clusters of 4 with
    one group (5 tokens); the weight bytes a call that the clusters pull
    from L2 fall by cs against one fetch a block of the same rows."""
    heads = 8 // tp
    d = c // 8
    for l in (1024, 256, 64, 69):
        plan = M.attn_plan(12, l, c, heads, c // tp, batch=4)
        _check_k4_plan(plan, 12, l, c, heads, 4, c // tp)
        assert (plan["cs"], plan["groups"], plan["lh"]) == ((2, 2, 5) if d == 80 else (4, 1, 5))
        blocks = 4 * -(-l // (plan["groups"] * plan["lh"]))
        assert plan["units"] * plan["cs"] < heads * blocks + heads * plan["cs"]


@pytest.mark.parametrize("c", [640, 1280])
def test_k4_plan_regime_of_every_head_dim(c):
    """At C = 640 and 1280 each head dim takes its regime: clusters at d =
    80, 128 and 160, the per-head kernel at d = 16-64 and 96 (off the main
    path, whose motion modules have d = 40 at C = 320 only)."""
    for d in M._HEAD_DIMS:
        if c % d:
            continue
        plan = M.attn_plan(12, 100, c, c // d, batch=2)
        assert plan["regime"] == ("cluster" if d in (80, 128, 160) else "heads"), d
        _check_k4_plan(plan, 12, 100, c, c // d, 2)


@pytest.mark.parametrize("f,l,c,heads", [(33, 64, 320, 8), (12, 64, 320, 7), (12, 64, 64, 8),
                                         (12, 64, 4096, 16), (12, 64, 1920, 8)])
def test_k4_plan_raises_on_shapes_it_does_not_take(f, l, c, heads):
    with pytest.raises(ValueError):
        M.attn_plan(f, l, c, heads)


# ------------------------------------------------------------------- K2
# the VAE at 512x512 (full width) and the card's tiny pipeline's VAE at
# 64x64; rows: a decode chunk of 8 frames, the trainer's 12 frames, the
# reference image
VAE_WIDTHS = {"full": ((128, 256, 512, 512), 512), "card tiny": ((32, 32, 64, 64), 64),
              "test tiny": ((32, 32, 64, 64), 32)}
VAE_ROWS = (8, 12, 1)


def unet_gn_pairs(chans, tokens, layers=2):
    """(L, C) of every GroupNorm of the denoising UNet (and ReferenceNet):
    the resnets' two norms, the spatial, audio and motion wrappers' norms,
    mid, the up blocks' concatenated inputs and conv_norm_out."""
    pairs, prev = set(), chans[0]
    for c, l in zip(chans, tokens):
        for _ in range(layers):
            pairs |= {(l, prev), (l, c)}
            prev = c
    skips, x_ch = skip_channels(chans, layers), chans[-1]
    for c, l in zip(reversed(chans), reversed(tokens)):
        for _ in range(layers + 1):
            pairs |= {(l, x_ch + skips.pop()), (l, c)}
            x_ch = c
    return pairs


def vae_gn_pairs(chans, size):
    """(L, C) of every GroupNorm of the VAE's encoder and decoder at size^2."""
    pairs, prev, s = set(), chans[0], size
    for i, c in enumerate(chans):
        for _ in range(2):
            pairs |= {(s * s, prev), (s * s, c)}
            prev = c
        s //= 2 if i < len(chans) - 1 else 1
    pairs.add((s * s, chans[-1]))  # mid resnets, mid attention, conv_norm_out
    for i, c in enumerate(reversed(chans)):
        for _ in range(3):
            pairs |= {(s * s, prev), (s * s, c)}
            prev = c
        s *= 2 if i < len(chans) - 1 else 1
    return pairs


def gn_path_shapes(config: str):
    """(N, L, C) of every GroupNorm call of `config`'s networks."""
    chans, tokens = WIDTHS[config]
    shapes = {(rows, l, c) for rows in ROWS for l, c in unet_gn_pairs(chans, tokens)}
    if config in VAE_WIDTHS:
        vchans, size = VAE_WIDTHS[config]
        shapes |= {(rows, l, c) for rows in VAE_ROWS for l, c in vae_gn_pairs(vchans, size)}
    return sorted(shapes)


def test_gn_path_shapes_cover_the_known_calls():
    full = gn_path_shapes("full")
    for shape in [(48, 4096, 320), (48, 4096, 960), (48, 4096, 640), (48, 1024, 1920),
                  (48, 64, 2560), (1, 4096, 320), (12, 1024, 640), (8, 512 * 512, 128),
                  (8, 512 * 512, 256), (8, 64 * 64, 512), (8, 256 * 256, 512)]:
        assert shape in full, shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_gn_plan_fits_every_path_shape(config, dtype):
    esize = 2 if dtype == torch.bfloat16 else 4
    for n, l, c in gn_path_shapes(config):
        g = math.gcd(c, 32)  # nn.layers.GroupNorm's groups for C < 32
        plan = N.gn_plan(n, l, c, g, dtype)
        assert plan["threads"] % (c * esize // 16) == 0 and plan["threads"] <= 1024
        assert plan["rows"] * plan["k"] >= l > (plan["k"] - 1) * plan["rows"]
        fits = N.gn_resident_smem(-(-l // N.MAX_CLUSTER), c, g, esize, N.MAX_CLUSTER) <= SMEM
        if fits:  # resident wherever a row fits a cluster of 16
            assert plan["regime"] == "resident", (n, l, c)
            assert 1 <= plan["k"] <= N.MAX_CLUSTER
            assert plan["smem"] == N.gn_resident_smem(plan["rows"], c, g, esize, plan["k"]) <= SMEM
            assert plan["ws"] == 0
        else:
            assert plan["regime"] == "streaming", (n, l, c)
            assert plan["smem"] == N.gn_stream_smem(c, g, esize) <= SMEM
            assert plan["ws"] == n * plan["k"] * 2 * g


def test_gn_plan_level0_is_resident_in_16_cta_clusters():
    """The UNet's level-0 row (4096 x 320 bf16, 2.6 MB) fits 16 CTAs of 160
    KB each, whether 48, 12 or 1 rows are normalised."""
    for n in (48, 12, 1):
        plan = N.gn_plan(n, 4096, 320, 32)
        assert (plan["regime"], plan["k"], plan["rows"]) == ("resident", 16, 256)
        assert plan["slab"] == 256 * 640


@pytest.mark.parametrize("shape", [(48, 1024, 640), (48, 256, 1280), (24, 1024, 640)])
def test_gn_plan_prefers_two_ctas_an_sm(shape):
    """Where the row allows it, the slabs are small enough for two CTAs to
    share an SM."""
    plan = N.gn_plan(*shape, 32)
    assert plan["regime"] == "resident" and plan["smem"] <= N.TWO_CTAS
    k = plan["k"] - 1
    assert N.gn_resident_smem(-(-shape[1] // k), shape[2], 32, 2, k) > N.TWO_CTAS


def test_gn_plan_spreads_few_rows_over_the_card():
    plan = N.gn_plan(48, 64, 1280, 32)  # level 3: 160 KB a row
    assert plan["regime"] == "resident" and plan["k"] * 48 >= N.SMS


@pytest.mark.parametrize("shape", [(48, 4096, 960), (48, 4096, 640), (48, 1024, 1920),
                                   (8, 512 * 512, 128), (8, 512 * 512, 256), (8, 4096, 512)])
def test_gn_plan_streams_rows_larger_than_a_cluster(shape):
    plan = N.gn_plan(*shape, 32)
    assert plan["regime"] == "streaming"
    assert shape[0] * plan["k"] >= N.SMS  # enough CTAs to fill the card


@pytest.mark.parametrize("n,l,c,groups,dtype", [
    (2, 64, 36, 4, torch.bfloat16), (2, 64, 320, 30, torch.bfloat16),
    (2, 64, 320, 32, torch.float16), (2, 64, 10240, 32, torch.bfloat16), (0, 64, 320, 32,
                                                                          torch.bfloat16),
    (2, 0, 320, 32, torch.bfloat16), (2, 64, 4100, 4100, torch.float32)])
def test_gn_plan_raises_on_shapes_it_does_not_take(n, l, c, groups, dtype):
    with pytest.raises(ValueError):
        N.gn_plan(n, l, c, groups, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [256, 384, 512, 640, 768, 1024, 1280, 1536, 2048])
def test_gn_plan_never_exceeds_shared_memory(c, dtype):
    """Over C or C/2 groups and L from 8 to 1600 (many groups make the
    cluster's partials grow with k, so the k that fit are not a run up to
    16): a resident plan fits 227 KB with a k that fits, and the largest
    fitting k where none leaves room for two CTAs an SM; else the row
    streams. Wherever a smaller cluster fits, the shape stays resident."""
    esize = 2 if dtype == torch.bfloat16 else 4
    for groups in (c, c // 2):
        for l in (8, 16, 32, 64, 100, 128, 200, 256, 333, 400, 512, 624, 625, 700, 800,
                  1024, 1200, 1600):
            plan = N.gn_plan(1, l, c, groups, dtype)
            smem = lambda k: N.gn_resident_smem(-(-l // k), c, groups, esize, k)
            fits = [k for k in range(1, N.MAX_CLUSTER + 1) if smem(k) <= SMEM]
            if not fits:
                assert plan["regime"] == "streaming", (l, c, groups)
                assert plan["smem"] == N.gn_stream_smem(c, groups, esize) <= SMEM
                continue
            assert plan["regime"] == "resident", (l, c, groups)
            assert plan["k"] in fits and plan["smem"] == smem(plan["k"]) <= SMEM
            if all(smem(k) > N.TWO_CTAS for k in fits):
                assert plan["k"] == max(fits), (l, c, groups)


@pytest.mark.parametrize("shape,dtype", [((1, 64, 768, 768), torch.float32),
                                         ((1, 64, 1024, 1024), torch.bfloat16),
                                         ((1, 32, 1536, 768), torch.float32)])
def test_gn_plan_formerly_over_the_limit(shape, dtype):
    """Three shapes whose plan once took k = 16 without checking that it
    fits (233,488, 311,312 and 236,560 bytes): now a smaller cluster."""
    plan = N.gn_plan(*shape, dtype)
    assert plan["regime"] == "resident" and plan["k"] < N.MAX_CLUSTER
    assert plan["smem"] <= SMEM


@pytest.mark.parametrize("samples", [51200, 64000, 102400])
def test_gn_plan_wav2vec2_conv0_streams(samples):
    """wav2vec2's conv-0 GroupNorm (512 groups of one channel, f32) on a
    3.2 s, 4 s and 6.4 s clip: streamed in about 4 CTAs an SM."""
    l = (samples - 10) // 5 + 1
    plan = N.gn_plan(1, l, 512, 512, torch.float32)
    assert plan["regime"] == "streaming" and plan["k"] >= 3 * N.SMS
    assert plan["smem"] == 14336 and plan["ws"] == plan["k"] * 2 * 512


# K1 at d = 512: (B, Sq, keys) of the VAE's mid attention on the main path
# (the reference encode, a decode chunk, the video train step's encode, the
# image pretrain's encode at 256^2) and a short sequence; splits on 132 SMs
@pytest.mark.parametrize("b,sq,keys,splits", [
    (1, 4096, 4096, 2), (8, 4096, 4096, 1), (12, 4096, 4096, 1), (4, 1024, 1024, 2),
    (1, 1024, 1024, 4), (1, 100, 100, 2)])
def test_k1_wide_splits_fill_the_card(b, sq, keys, splits):
    got = A.wide_splits(b, 1, sq, keys, 132)
    assert got == splits
    blocks = -(-sq // A.WIDE_TILE) * b
    assert 1 <= got <= A.MAX_SPLITS and got * blocks <= max(132, blocks)
