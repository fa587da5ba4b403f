"""mmgt_tpu_torch modules (CPU, f32) against mmgt_tpu's flax modules with
the same noised parameters, carried across by `load_jax_params`.

Tolerances: 1e-4 (relative and absolute) for single blocks, where f32
sums in another order and the Upsample's 4-phase form on the JAX side
differ by ~1e-6; 1e-3 for whole networks, whose depth compounds those
differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.models import blocks as JB
from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.nn.layers import Attention as JAttention
from mmgt_tpu_torch.models import blocks as B
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D, bank_attn_names, precompute_bank_kv
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.nn.layers import Attention, LayerNorm
from mmgt_tpu_torch.utils import convert as PC
from torch_port_util import close, init_noised, one_torch_thread, t  # noqa: F401

CHANS = (32, 64, 64, 64)
HEADS = 8
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
NET_TOL = dict(rtol=1e-3, atol=1e-3)


def sub_mapper(jax_prefix: str, torch_prefix: str):
    """Map the keys of one block through map_unet3d at a UNet location
    where such a block lives, then strip that location."""
    def mapper(key):
        full = PC.map_unet3d(jax_prefix + key)
        assert full.startswith(torch_prefix), (full, torch_prefix)
        return full[len(torch_prefix):]
    return mapper


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _load(port, params, mapper):
    return PC.load_jax_params(port, params, mapper).eval()


@torch.no_grad()
def test_attention_with_bank_and_kv_lens():
    rng = np.random.default_rng(0)
    b, l, lb, c = 3, 12, 10, 64
    x, bank = _rand(rng, b, l, c), _rand(rng, 1, lb, c)
    scale, bias = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
    lens = np.array([l, l + lb, l + lb], np.int32)
    jm = JAttention(HEADS, c // HEADS)
    pre = (jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    bank_b = jnp.asarray(np.repeat(bank, b, 0))
    params = init_noised(jm, jnp.asarray(x), kv_lens=jnp.asarray(lens), pre_norm=pre,
                         bank=bank_b)
    want = jm.apply(params, jnp.asarray(x), kv_lens=jnp.asarray(lens), pre_norm=pre,
                    bank=bank_b)
    port = _load(Attention(c, HEADS, c // HEADS), params,
                 sub_mapper("down_0_attn_0/block/attn1/",
                            "down_blocks.0.attentions.0.transformer_blocks.0.attn1."))
    ln = LayerNorm(c)
    ln.weight.copy_(t(scale))
    ln.bias.copy_(t(bias))
    kb = port.to_k(t(bank)).reshape(1, lb, HEADS, c // HEADS)
    vb = port.to_v(t(bank)).reshape(1, lb, HEADS, c // HEADS)
    got = port(t(x), kv_lens=torch.from_numpy(lens), pre_norm=ln, bank_kv=(kb, vb))
    close(got, want, **BLOCK_TOL)


@torch.no_grad()
def test_audio_block_with_uncond_rows():
    rng = np.random.default_rng(1)
    b, l, c, nu = 4, 16, 64, 2
    x, audio = _rand(rng, b, l, c), _rand(rng, b, 32, 768)
    audio[:nu] = 0.0  # the CFG-uncond contract
    masks = tuple((rng.uniform(size=(b, l)) > 0.4).astype(np.float32) for _ in range(3))
    ms = (1.3, 0.7, 0.4)
    jm = JB.AudioTransformerBlock(HEADS, c // HEADS)
    jargs = (jnp.asarray(x), jnp.asarray(audio), tuple(map(jnp.asarray, masks)), ms, nu)
    params = init_noised(jm, *jargs)
    want = jm.apply(params, *jargs)
    port = _load(B.AudioTransformerBlock(c, HEADS, c // HEADS), params,
                 sub_mapper("down_0_audio_0/block/",
                            "down_blocks.0.audio_modules.0.transformer_blocks.0."))
    got = port(t(x), t(audio), tuple(map(t, masks)), ms, nu)
    close(got, want, **BLOCK_TOL)


@torch.no_grad()
def test_motion_module():
    rng = np.random.default_rng(2)
    f, hw, c = 4, 8, 64
    x = _rand(rng, 2 * f, hw, hw, c)
    jm = JB.MotionModule(HEADS)
    params = init_noised(jm, jnp.asarray(x), f)
    want = jm.apply(params, jnp.asarray(x), f)
    port = _load(B.MotionModule(c, HEADS), params,
                 sub_mapper("down_0_motion_0/", "down_blocks.0.motion_modules.0."))
    close(port(t(x), f), want, **BLOCK_TOL)


@pytest.mark.parametrize("cin,cout,temb", [(32, 64, 128), (64, 64, None)])
@torch.no_grad()
def test_resnet_block(cin, cout, temb):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 8, cin)
    te = None if temb is None else _rand(rng, 2, temb)
    jm = JB.ResnetBlock(cout)
    jargs = (jnp.asarray(x),) + (() if te is None else (jnp.asarray(te),))
    params = init_noised(jm, *jargs)
    want = jm.apply(params, *jargs)
    port = _load(B.ResnetBlock(cin, cout, temb), params,
                 sub_mapper("down_0_res_0/", "down_blocks.0.resnets.0."))
    close(port(t(x), None if te is None else t(te)), want, **BLOCK_TOL)


@pytest.mark.parametrize("kind", ["down", "down_vae", "up"])
@torch.no_grad()
def test_down_and_upsample(kind):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 8, 8, 32)
    if kind == "up":
        jm, port, pre = JB.Upsample(), B.Upsample(32), ("up_0_upsample/", "up_blocks.0.upsamplers.0.")
    else:
        pad = ((0, 1), (0, 1)) if kind == "down_vae" else ((1, 1), (1, 1))
        jm, port = JB.Downsample(pad=pad), B.Downsample(32, pad)
        pre = ("down_0_downsample/", "down_blocks.0.downsamplers.0.")
    params = init_noised(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    port = _load(port, params, sub_mapper(*pre))
    close(port(t(x)), want, **BLOCK_TOL)


# ------------------------------------------------------------- networks
@torch.no_grad()
def test_reference_unet_banks_in_order():
    rng = np.random.default_rng(5)
    lat, ctx = _rand(rng, 1, 8, 8, 4), _rand(rng, 1, 1, 768)
    tt = np.zeros((1,), np.int32)
    jm = JUNet2D(block_out_channels=CHANS, heads=HEADS)
    jargs = (jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(ctx))
    params = init_noised(jm, *jargs)
    want_sample, want_banks = jax.jit(jm.apply)(params, *jargs)
    port = _load(ReferenceUNet2D(CHANS, heads=HEADS), params, PC.map_unet2d)
    sample, banks = port(t(lat), torch.zeros(1, dtype=torch.long), t(ctx))
    assert len(banks) == len(want_banks) == 16
    for i, (g, w) in enumerate(zip(banks, want_banks)):
        close(g, w, **NET_TOL, msg=f"bank {i}")
    close(sample, want_sample, **NET_TOL)


@torch.no_grad()
def test_denoising_unet_with_precomputed_bank_kv():
    rng = np.random.default_rng(6)
    b, f, h = 2, 3, 8
    lat = _rand(rng, b, f, h, h, 4)
    tt = np.array([501, 501], np.int32)
    ctx = _rand(rng, b, 1, 768)
    audio = _rand(rng, b, f, 32, 768)
    ctx[:1], audio[:1] = 0.0, 0.0  # row 0 is the CFG-uncond row
    pose = _rand(rng, b, f, h, h, CHANS[0], scale=0.1)
    masks = [tuple((rng.uniform(size=(b, f, (h >> lv) ** 2)) > 0.4).astype(np.float32)
                   for _ in range(3)) for lv in range(3)]
    shapes = [(ll, c) for ll, c in _bank_shapes(h)]
    banks = [_rand(rng, 1, ll, c) for ll, c in shapes]
    ms = (1.0, 1.0, 1.0)
    jm = JUNet3D(block_out_channels=CHANS, heads=HEADS)
    jmasks = [tuple(map(jnp.asarray, lv)) for lv in masks]
    jbanks = [jnp.asarray(np.repeat(bk, b, 0)) for bk in banks]
    jargs = (jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(ctx), jnp.asarray(audio),
             jnp.asarray(pose), jmasks)
    params = init_noised(jm, *jargs, jbanks)
    want = jax.jit(jm.apply, static_argnums=(8, 9))(params, *jargs, jbanks, ms, 1)
    port = _load(DenoisingUNet3D(CHANS, heads=HEADS), params, PC.map_unet3d)
    banks_kv = precompute_bank_kv(port, [t(bk) for bk in banks])
    got = port(t(lat), torch.from_numpy(tt).long(), t(ctx), t(audio), t(pose),
               [tuple(map(t, lv)) for lv in masks], banks_kv, ms, n_uncond=1)
    close(got, want, **NET_TOL)


def _bank_shapes(h8):
    names = bank_attn_names(CHANS, 2)
    lvl = {"down_0": 0, "down_1": 1, "down_2": 2, "mid": 3, "up_1": 2, "up_2": 1, "up_3": 0}
    return [((h8 >> lvl[n.rsplit("_attn", 1)[0]]) ** 2, c) for n, c in names]


@torch.no_grad()
def test_vae_encode_and_decode():
    rng = np.random.default_rng(7)
    x, z = _rand(rng, 2, 64, 64, 3), _rand(rng, 2, 8, 8, 4)
    jm = JVAE(block_out_channels=(32, 32, 64, 64))
    params = init_noised(jm, jnp.asarray(x))
    port = _load(AutoencoderKL((32, 32, 64, 64)), params, PC.map_vae)
    apply = jax.jit(jm.apply, static_argnames="method")
    want_enc = apply(params, jnp.asarray(x), method=JVAE.encode_scaled)
    want_dec = apply(params, jnp.asarray(z), method=JVAE.decode_scaled)
    close(port.encode_scaled(t(x)), want_enc, **NET_TOL)
    close(port.decode_scaled(t(z)), want_dec, **NET_TOL)


@torch.no_grad()
def test_pose_guider():
    rng = np.random.default_rng(8)
    pose = rng.uniform(size=(1, 2, 64, 64, 3)).astype(np.float32)
    jm = JPoseGuider(embedding_channels=32, block_out_channels=(4, 8, 8, 16))
    params = init_noised(jm, jnp.asarray(pose))
    port = _load(PoseGuider(32, (4, 8, 8, 16)), params, PC.map_pose_guider)
    close(port(t(pose)), jm.apply(params, jnp.asarray(pose)), **BLOCK_TOL)


@torch.no_grad()
def test_audio_proj():
    rng = np.random.default_rng(9)
    a = _rand(rng, 1, 2, 5, 12, 768)
    jm = JAudioProj(intermediate_dim=32)
    params = init_noised(jm, jnp.asarray(a))
    port = _load(AudioProjModel(intermediate_dim=32), params, PC.map_audio_proj)
    close(port(t(a)), jm.apply(params, jnp.asarray(a)), **BLOCK_TOL)
