"""The audio2vid slice's encoders: mmgt_tpu_torch's CLIP, wav2vec2 and
WavLM (CPU, f32, plain versions) against mmgt_tpu's, at tiny widths with
the same noised parameters (carried by `load_jax_params` through the
port's copies of the reference mappers), and the pieces around them:
`clip_preprocess` and `linear_interpolate_seq` (antialiased resizes, up
and down), the Conv1d and grouped-conv weight transfer, the audio
processor and `dot_product_attention`'s routing.

Tolerances: 1e-5 absolute for single ops and weight transfer (f32
rounding); 1e-4 relative and absolute through a network (a few f32
roundings a layer; outputs of order 1-3); resizes 1e-4 (the JAX weights
are computed in f32, the port's in float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.data.audio import AudioProcessor as JAudioProcessor
from mmgt_tpu.data.audio import stack_audio_window as j_stack
from mmgt_tpu.data.dsp import save_wav
from mmgt_tpu.models.clip_vision import CLIPVisionModel as JCLIP
from mmgt_tpu.models.clip_vision import clip_preprocess as j_clip_preprocess
from mmgt_tpu.models.wav2vec2 import ConvFeatureExtractor as JConvFE
from mmgt_tpu.models.wav2vec2 import ConvPositionalEmbedding as JPosConv
from mmgt_tpu.models.wav2vec2 import Wav2Vec2Model as JW2V
from mmgt_tpu.models.wav2vec2 import linear_interpolate_seq as j_interp
from mmgt_tpu.models.wavlm import WavLMModel as JWavLM
from mmgt_tpu.models.wavlm import relative_position_buckets as j_buckets
from mmgt_tpu.ops.attention import _xla_attention
from mmgt_tpu_torch.data.audio import AudioProcessor, stack_audio_window
from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel, clip_preprocess
from mmgt_tpu_torch.models.wav2vec2 import (
    ConvFeatureExtractor,
    ConvPositionalEmbedding,
    Wav2Vec2Model,
    linear_interpolate_seq,
)
from mmgt_tpu_torch.models.wavlm import WavLMModel, relative_position_buckets
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, from_flax_tensor, load_jax_params
from torch_port_util import close, init_noised, t

NET = dict(rtol=1e-4, atol=1e-4)
OP = dict(rtol=0, atol=1e-5)
TINY = dict(hidden_dim=32, num_layers=2, heads=4)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape,size", [((1, 512, 512, 3), 224), ((2, 96, 80, 3), 224),
                                        ((1, 100, 150, 3), 224)])
def test_clip_preprocess_matches(shape, size):
    """512 -> 224 downsamples (antialiased, as jax.image.resize); 96x80 ->
    224 upsamples; 100x150 mixes both."""
    img = _rng().uniform(size=shape).astype(np.float32)
    close(clip_preprocess(t(img), size), j_clip_preprocess(jnp.asarray(img), size),
          rtol=0, atol=1e-4)


@pytest.mark.parametrize("t_in,t_out", [(159, 80), (20479, 160), (199, 100), (8, 20), (80, 80)])
def test_linear_interpolate_seq_matches(t_in, t_out):
    """Down (wav2vec2's ~50 frames/s to 25 fps, and a 6.4 s clip's conv
    frames to 160) and up."""
    x = _rng(1).standard_normal((2, t_in, 6)).astype(np.float32)
    got = linear_interpolate_seq(t(x), t_out)
    assert got.shape == (2, t_out, 6)
    close(got, j_interp(jnp.asarray(x), t_out), rtol=0, atol=1e-4)


def test_clip_vision_matches():
    jm = JCLIP(patch=14, image_size=56, proj_dim=16, **TINY)
    px = _rng(2).standard_normal((2, 56, 56, 3)).astype(np.float32)
    params = init_noised(jm, jnp.asarray(px), seed=3)
    pm = load_jax_params(CLIPVisionModel(patch=14, image_size=56, proj_dim=16, **TINY),
                         params, ENCODER_MAPPERS["clip"])
    with torch.no_grad():
        got = pm(t(px))
    assert got.shape == (2, 1, 16)
    close(got, jm.apply(params, jnp.asarray(px)), **NET)


def test_conv1d_kernels_transfer_to_torch_layout():
    """flax (k, in/groups, out) -> torch (out, in/groups, k), plain and
    grouped (wav2vec2's and WavLM's pos_conv: 16 groups, kernel 128)."""
    a = _rng(4).standard_normal((128, 4, 64)).astype(np.float32)
    got = from_flax_tensor("pos_conv/conv/kernel", a, (64, 4, 128))
    np.testing.assert_array_equal(got, a.transpose(2, 1, 0))
    with pytest.raises(ValueError):
        from_flax_tensor("pos_conv/conv/kernel", a, (64, 128, 4))


def test_grouped_pos_conv_matches():
    """ConvPositionalEmbedding (kernel 128, padding 64, 16 groups, trailing
    element dropped, GELU) through the weight transfer."""
    jm = JPosConv()
    x = _rng(5).standard_normal((2, 150, 64)).astype(np.float32)
    params = init_noised(jm, jnp.asarray(x), seed=6)
    conv = ConvPositionalEmbedding(64)
    tree = params["params"]["conv"]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(from_flax_tensor("conv/kernel", tree["kernel"],
                                                            conv.weight.shape)))
        conv.bias.copy_(t(tree["bias"]))
        got = conv(t(x))
    assert conv.weight.shape == (64, 4, 128)
    close(got, jm.apply(params, jnp.asarray(x)), **NET)


@pytest.mark.parametrize("mode", ["group", "layer"])
def test_conv_feature_extractor_matches(mode):
    """The 7-conv extractor; in "group" mode conv 0 is followed by the
    GroupNorm of 512 groups of one channel (K2's call site on the card)."""
    jm = JConvFE(mode)
    wav = _rng(7).standard_normal((2, 3200)).astype(np.float32)
    params = init_noised(jm, jnp.asarray(wav), seed=8)
    pm = ConvFeatureExtractor(mode)
    mapper = ENCODER_MAPPERS["wav2vec2" if mode == "group" else "wavlm"]
    load_jax_params(pm, params, lambda k: mapper("feature_extractor/" + k)[len("feature_extractor."):])
    if mode == "group":
        gn = pm.conv_layers[0].layer_norm
        assert gn.num_groups == 512 and gn.weight.shape == (512,)
    with torch.no_grad():
        got = pm(t(wav))
    assert got.shape == (2, 9, 512)
    close(got, jm.apply(params, jnp.asarray(wav)), **NET)


def _w2v(seed=9):
    jm = JW2V(ff_dim=64, **TINY)
    wav = _rng(seed).standard_normal((1, 6400)).astype(np.float32)
    params = init_noised(jm, jnp.asarray(wav), 10, seed=seed)
    pm = load_jax_params(Wav2Vec2Model(ff_dim=64, **TINY), params, ENCODER_MAPPERS["wav2vec2"])
    return jm, pm, params, wav


def test_wav2vec2_matches():
    """Stacked hidden states (B, T, layers, hidden); the conv features (19
    frames of 0.4 s) are downsampled to 10 before the transformer."""
    jm, pm, params, wav = _w2v()
    with torch.no_grad():
        got = pm(t(wav), 10)
    assert got.shape == (1, 10, 2, 32)
    close(got, jm.apply(params, jnp.asarray(wav), 10), **NET)


def test_audio_processor_matches(tmp_path):
    """wav file -> normalised, padded to a clip multiple, encoded, windowed
    +-2 frames: (1, T, 5, layers, hidden)."""
    jm, pm, params, _ = _w2v(11)
    wav = (0.1 * np.sin(np.linspace(0, 300, 8000))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    save_wav(path, wav, 16000)
    want, want_len = JAudioProcessor(jm, params).preprocess(path, clip_length=8)
    got, got_len = AudioProcessor(pm).preprocess(path, clip_length=8)
    assert got_len == want_len == 13 and got.shape == (1, 16, 5, 2, 32)
    close(got, want, **NET)


def test_stack_audio_window_matches():
    emb = _rng(12).standard_normal((7, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(stack_audio_window(t(emb)).numpy(),
                                  np.asarray(j_stack(jnp.asarray(emb))))


def test_relative_position_buckets_match():
    np.testing.assert_array_equal(relative_position_buckets(300, 300), j_buckets(300, 300))


def test_wavlm_matches():
    """Gated relative-position bias (made in layer 0, gated in every
    layer), pre-norm layers, final LayerNorm."""
    jm = JWavLM(ff_dim=64, num_buckets=32, max_distance=40, **TINY)
    wav = _rng(13).standard_normal((1, 6400)).astype(np.float32)
    params = init_noised(jm, jnp.asarray(wav), seed=14)
    pm = load_jax_params(WavLMModel(ff_dim=64, num_buckets=32, max_distance=40, **TINY),
                         params, ENCODER_MAPPERS["wavlm"])
    assert pm.encoder.layers[0].self_attn.relative_attention_bias is not None
    assert pm.encoder.layers[1].self_attn.relative_attention_bias is None
    with torch.no_grad():
        got = pm(t(wav))
    assert got.shape == (1, 19, 32)
    close(got, jm.apply(params, jnp.asarray(wav)), **NET)


@pytest.mark.parametrize("sq,skv", [(80, 82), (257, 257), (600, 600), (600, 1)])
def test_dot_product_attention_matches_xla_math(sq, skv):
    """On the CPU every length takes the plain math (`_xla_attention`'s);
    a single key returns v. No K1 launch on a CPU tensor."""
    rng = _rng(15)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 4, 16)).astype(np.float32) for _ in range(2))
    before = A.LAUNCHES
    got = A.dot_product_attention(t(q), t(k), t(v))
    assert A.LAUNCHES == before
    bhsd = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = np.asarray(_xla_attention(bhsd(q), bhsd(k), bhsd(v), 0.25)).transpose(0, 2, 1, 3)
    close(got, want, **OP)
