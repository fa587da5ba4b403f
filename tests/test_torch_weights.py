"""The port's checkpoint loading against mmgt_tpu's, on the CPU.

Each copied helper (`fold_weight_norm` in both weight-norm APIs,
`split_packed_qkv`, `split_net_checkpoint`, `load_torch_state_dict`'s
wrapper unwrap and unrestricted retry, `load_smga_state_dict`'s `module.`
prefix and EMA pick) gives bitwise the JAX original's tensors on small
synthetic dicts, and the port's `.safetensors` reader gives what
`safetensors.numpy` reads.

The drill: a tiny-width reference-layout weights directory written in
fp16 from the port's own modules (the Net-wrapper `net-*.pth`, the VAE as
`.safetensors`, an SMGA checkpoint with EMA weights, a `module.` prefix
and packed q/k/v) is loaded by both packages' `load_all_weights`; the JAX
trees, carried into fresh port modules by `load_jax_params`, equal the
port's loaded modules bitwise (bf16 Stage 2, f32 SMGA). A checkpoint that
does not cover its model gives the random fill and the warning in both.
The full-size encoder files (CLIP, wav2vec2, WavLM) are drilled on the
card only (`chip_smoke.py`'s `weights` phase): their JAX trees take
minutes to convert here.
"""
import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from mmgt_tpu.training.stage1 import SMGA as JSMGA
from mmgt_tpu.utils import convert as JC
from mmgt_tpu.utils import weights as JW
from mmgt_tpu_torch.training.stage1 import SMGA
from mmgt_tpu_torch.utils import convert as PC
from mmgt_tpu_torch.utils import weights as PW
from test_torch_pipeline import CHANS, HEADS, VAE_CHANS, _random_port_pipeline

NET_PREFIX = {"reference_unet": "reference_unet", "denoising_unet": "denoising_unet",
              "pose_guider": "pose_guider", "audio_proj": "audioproj"}


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _fp16(shape, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float16))


# ------------------------------------------------------------- the helpers
@pytest.mark.parametrize("api", ["old", "new"])
def test_fold_weight_norm_matches_jax(api):
    rng = np.random.default_rng(0)
    v, g = _fp16((8, 4, 16), rng), _fp16((1, 1, 16), rng)
    names = (("conv.weight_g", "conv.weight_v") if api == "old" else
             ("conv.parametrizations.weight.original0", "conv.parametrizations.weight.original1"))
    sd = {names[0]: g, names[1]: v, "conv.bias": _fp16((8,), rng)}
    got = PC.fold_weight_norm(sd)
    assert set(got) == {"conv.weight", "conv.bias"} and got["conv.weight"].dtype == torch.float16
    _same(got, JC.fold_weight_norm(_np(sd)))


@pytest.mark.parametrize("dim", [0, 2, None])
@pytest.mark.parametrize("api", ["old", "new"])
def test_fold_weight_norm_matches_torch(api, dim):
    """torch's own weight norm is the oracle here (mmgt_tpu's copy
    normalises over every axis but the last when g is 0-dim, as
    `weight_norm(dim=None)` makes it): the folded weight equals the
    module's computed weight within 1e-6 of its largest |w|, f32."""
    import warnings

    torch.manual_seed(3)
    conv = torch.nn.Conv1d(4, 6, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if api == "old":
            torch.nn.utils.weight_norm(conv, dim=dim)
        else:
            torch.nn.utils.parametrizations.weight_norm(conv, dim=dim)
    with torch.no_grad():  # g away from ||v||, so the fold's g matters
        g = (conv.weight_g if api == "old" else conv.parametrizations.weight.original0)
        g.mul_(1.5)
        conv(torch.zeros(1, 4, 5))  # the old API recomputes the weight in its forward hook
        want = conv.weight.detach().clone()
    sd = {f"conv.{k}": v.detach() for k, v in conv.state_dict().items()}
    assert sd[[k for k in sd if k.endswith(("weight_g", "original0"))][0]].ndim == (
        0 if dim is None else 3)
    got = PC.fold_weight_norm(sd)
    assert set(got) == {"conv.weight", "conv.bias"} and got["conv.weight"].dtype == torch.float32
    err = (got["conv.weight"] - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err


def test_split_packed_qkv_and_net_split_match_jax():
    rng = np.random.default_rng(1)
    sd = {"a.self_attn.in_proj_weight": _fp16((12, 4), rng),
          "a.self_attn.in_proj_bias": _fp16((12,), rng), "a.out.weight": _fp16((4, 4), rng)}
    _same(PC.split_packed_qkv(sd), JC.split_packed_qkv(_np(sd)))
    net = {f"{p}.w": _fp16((2,), rng) for p in ("reference_unet", "denoising_unet",
                                                "pose_guider", "audioproj")}
    net["stray"] = _fp16((1,), rng)
    got, want = PC.split_net_checkpoint(net), JC.split_net_checkpoint(_np(net))
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("wrapper", ["none", "state_dict", "model_cfg"])
def test_load_torch_state_dict_matches_jax(tmp_path, wrapper):
    """The "state_dict" and "model" wrappers; the WavLM release's
    {"model", "cfg"} pickles an argparse Namespace, which the restricted
    read refuses and the unrestricted retry takes."""
    rng = np.random.default_rng(2)
    sd = {"x.weight": _fp16((3, 2), rng), "pos.weight_g": _fp16((1, 1, 5), rng),
          "pos.weight_v": _fp16((4, 2, 5), rng)}
    obj = {"none": sd, "state_dict": {"state_dict": sd, "epoch": 3},
           "model_cfg": {"model": sd, "cfg": argparse.Namespace(layers=2)}}[wrapper]
    path = str(tmp_path / "ckpt.pt")
    torch.save(obj, path)
    got = PC.load_torch_state_dict(path)
    assert set(got) == {"x.weight", "pos.weight"}
    _same(got, JC.load_torch_state_dict(path))


@pytest.mark.parametrize("ema", [True, False])
def test_load_smga_state_dict_matches_jax(tmp_path, ema):
    rng = np.random.default_rng(3)
    make = lambda: {"module.l.self_attn.in_proj_weight": _fp16((6, 2), rng),
                    "module.l.self_attn.in_proj_bias": _fp16((6,), rng),
                    "module.head.weight": _fp16((2, 2), rng)}
    path = str(tmp_path / "smga.pt")
    torch.save({"ema_state_dict": make(), "model_state_dict": make(),
                "optimizer_state_dict": {}, "normalizer": None}, path)
    got = PC.load_smga_state_dict(path, ema=ema)
    assert "l.self_attn.q_proj.weight" in got and "head.weight" in got
    _same(got, JC.load_smga_state_dict(path, ema=ema))


def test_safetensors_reader_matches_safetensors_numpy(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(4)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
              "u8": rng.integers(0, 255, (4,)).astype(np.uint8),
              "scalar": np.asarray(1.5, np.float32), "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "w.safetensors")
    save_file(arrays, path, metadata={"format": "pt"})
    got = PC.read_safetensors(path)
    _same(got, load_file(path))
    _same(PC.load_torch_state_dict(path), load_file(path))


def test_load_checkpoint_rules():
    """Later dicts win; an uncovered key raises before anything is
    written unless allowed missing (then it keeps its value); unexpected
    keys are reported; values are cast to the module's dtype, through
    value_dtype when given; a 1x1 convolution feeds a Linear."""
    lin = torch.nn.Linear(3, 2).to(torch.bfloat16)
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    first = {"weight": torch.ones(2, 3, 1, 1, dtype=torch.float16), "extra": torch.zeros(1)}
    with pytest.raises(KeyError):
        PC.load_checkpoint(lin, [first])
    assert torch.equal(lin.weight, w0)
    report = PC.load_checkpoint(lin, [first, {"weight": torch.full((2, 3), 1.00390625)}],
                                missing_ok=[r"^bias$"])
    assert report == {"missing": ["bias"], "unexpected": ["extra"]}
    assert lin.weight.dtype == torch.bfloat16 and torch.equal(lin.weight.float(),
                                                              torch.full((2, 3), 1.0))
    assert torch.equal(lin.bias, b0)
    PC.load_checkpoint(lin, [first], missing_ok=[r"^bias$"])  # (O, I, 1, 1) into (O, I)
    assert torch.equal(lin.weight, torch.ones(2, 3, dtype=torch.bfloat16))
    f32 = torch.nn.Linear(3, 2)
    PC.load_checkpoint(f32, [{"weight": torch.full((2, 3), 1.00390625), "bias": torch.ones(2)}],
                       value_dtype=torch.bfloat16)
    assert f32.weight.dtype == torch.float32 and torch.equal(f32.weight, torch.ones(2, 3))
    with pytest.raises(ValueError):
        PC.load_checkpoint(f32, [{"weight": torch.ones(3, 3), "bias": torch.ones(2)}])


def test_missing_ok_patterns_select_the_jax_keys():
    """The port's allowed-missing patterns pick, in port key names,
    exactly the keys whose JAX names the JAX package's patterns pick
    (`mmgt_tpu/utils/weights.py:139,153-154`, applied there to
    "params/"-prefixed flat keys)."""
    jax_ok = {"reference_unet": (r"^(params/)?conv_(norm_)?out",),
              "denoising_unet": (r"_(audio|motion)_", r"^mid_(audio|motion)",
                                 r"audio_cross|zero_conv|motion_pe")}
    port_ok = {"reference_unet": PW.REFERENCE_UNET_MISSING_OK,
               "denoising_unet": PW.DENOISING_UNET_MISSING_OK}
    shapes = jax.eval_shape(lambda: _jax_pipeline(jnp.float32).init_params(
        jax.random.PRNGKey(0), 64, 64))
    mapper = {"reference_unet": JC.map_unet2d, "denoising_unet": JC.map_unet3d}
    for name in ("reference_unet", "denoising_unet"):
        flat = jax.tree_util.tree_flatten_with_path(shapes[name])[0]
        picked = 0
        for path, _ in flat:
            key = "/".join(str(p.key) for p in path)
            want = any(re.search(p, key) for p in jax_ok[name])
            got = any(re.search(p, mapper[name](key.split("/", 1)[1])) for p in port_ok[name])
            assert got == want, key
            picked += want
        assert picked > 0, name


# --------------------------------------------------------------- the drill
def _jax_pipeline(dtype):
    tiny = dict(block_out_channels=CHANS, heads=HEADS, dtype=dtype)
    return JPipeline(
        vae=JVAE(block_out_channels=VAE_CHANS, dtype=dtype), reference_unet=JUNet2D(**tiny),
        denoising_unet=JUNet3D(**tiny),
        pose_guider=JPoseGuider(embedding_channels=CHANS[0], block_out_channels=(4, 8, 8, 16),
                                dtype=dtype),
        audio_proj=JAudioProj(intermediate_dim=32, dtype=dtype), context_size=6,
        context_overlap=2)


def _pack_qkv(sd):
    """The reference GestureDecoder's layout: q/k/v packed into
    nn.MultiheadAttention's in_proj_weight / in_proj_bias."""
    out = dict(sd)
    for k in list(sd):
        m = re.match(r"(.*)\.q_proj\.(weight|bias)$", k)
        if m:
            base, kind = m.groups()
            parts = [out.pop(f"{base}.{p}_proj.{kind}") for p in "qkv"]
            out[f"{base}.in_proj_{kind}"] = torch.cat(parts, 0)
    return out


def _write_weights_dir(root, pipe, smga, partial=False):
    """Reference-layout fp16 files from the port's modules."""
    from safetensors.numpy import save_file

    half = lambda m: {k: v.detach().to(torch.float16).clone() for k, v in m.state_dict().items()}
    if partial:  # a pose guider checkpoint that lacks a tensor, and nothing else
        sd = half(pipe.pose_guider)
        sd.pop("conv_out.bias")
        torch.save(sd, root / "pose_guider-1.pth")
        return
    net = {f"{NET_PREFIX[n]}.{k}": v for n in NET_PREFIX for k, v in half(getattr(pipe, n)).items()}
    torch.save(net, root / "net-100.pth")
    (root / "sd-vae-ft-mse").mkdir()
    save_file({k: v.numpy() for k, v in half(pipe.vae).items()},
              str(root / "sd-vae-ft-mse" / "diffusion_pytorch_model.safetensors"))
    ema = {f"module.{k}": v for k, v in _pack_qkv(half(smga.model)).items()}
    other = {k: torch.zeros_like(v) for k, v in ema.items()}
    torch.save({"ema_state_dict": ema, "model_state_dict": other, "normalizer": None},
               root / "smga.pt")


def _to_f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def source():
    torch.manual_seed(0)
    pipe = _random_port_pipeline()
    smga = SMGA()
    from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

    init_random_params(smga.model, torch.Generator().manual_seed(5))
    return pipe, smga


def _fresh(dtype):
    pipe = _random_port_pipeline()
    for m in pipe.models().values():
        m.to(dtype)
    pipe.init_params(seed=9)
    return pipe


def test_load_all_weights_drill_matches_jax(tmp_path, source, capsys):
    _write_weights_dir(tmp_path, *source)
    pipe, smga = _fresh(torch.bfloat16), SMGA()
    out = PW.load_all_weights(str(tmp_path), pipe, smga, device="cpu")
    assert "random fill" not in capsys.readouterr().err
    assert out["random_fill"] == [] and out["smga"] is smga
    assert out["smga_feature_type"] == "wavlm"
    assert not {"clip_model", "audio_processor", "wavlm"} & set(out)
    want = JW.load_all_weights(str(tmp_path), _jax_pipeline(jnp.bfloat16), JSMGA())
    assert "random fill" not in capsys.readouterr().err
    from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, PIPELINE_MAPPERS, load_jax_params

    ref = _fresh(torch.bfloat16)
    for name, model in pipe.models().items():
        load_jax_params(ref.models()[name], _to_f32(want["pose2vid"][name]),
                        PIPELINE_MAPPERS[name])
        _same(model.state_dict(), {k: v.float().numpy()
                                   for k, v in ref.models()[name].state_dict().items()})
        # and what was written, cast to bf16
        written = getattr(source[0], name).state_dict()
        for k, v in model.state_dict().items():
            assert torch.equal(v, written[k].to(torch.float16).to(torch.bfloat16)), (name, k)
    jsmga = SMGA()
    load_jax_params(jsmga.model, _to_f32(want["smga"]), ENCODER_MAPPERS["smga"])
    _same(smga.model.state_dict(), _np(jsmga.model.state_dict()))
    written = source[1].model.state_dict()
    for k, v in smga.model.state_dict().items():
        assert torch.equal(v, written[k].to(torch.float16).float()), k


def test_load_all_weights_on_a_mesh_keeps_this_ranks_slices(tmp_path, source):
    """As the training CLIs load on a mesh (tp = 2, rank 1; no process
    group: neither step issues a collective): `load_all_weights` loads the
    whole tensors, then `shard_` keeps rank 1's tensor-parallel slice of
    every sharded weight, bitwise."""
    from mmgt_tpu_torch.parallel.mesh import Mesh, local_slice

    _write_weights_dir(tmp_path, *source)
    mesh = Mesh(world=2, rank=1, dp=1, tp=2, device=torch.device("cpu"))
    pipe = _fresh(torch.bfloat16)
    out = PW.load_all_weights(str(tmp_path), pipe, SMGA(), device="cpu")
    pipe.shard_(mesh)
    assert out["random_fill"] == [] and pipe.mesh is mesh
    from mmgt_tpu_torch.parallel.mesh import param_shardings

    specs = param_shardings(mesh, pipe.models())
    assert sum(s is not None for s in specs.values()) > 0
    for name, model in pipe.models().items():
        written = getattr(source[0], name).state_dict()
        for k, v in model.state_dict().items():
            want = written[k].to(torch.float16).to(torch.bfloat16)
            assert torch.equal(v, local_slice(want, specs[f"{name}.{k}"], mesh)), (name, k)


def test_partial_checkpoint_random_fills_in_both(tmp_path, source, capsys):
    _write_weights_dir(tmp_path, *source, partial=True)
    pipe = _fresh(torch.float32)
    out = PW.load_all_weights(str(tmp_path), pipe, SMGA(), device="cpu")
    port_err = capsys.readouterr().err
    JW.load_all_weights(str(tmp_path), _jax_pipeline(jnp.float32), JSMGA())
    jax_err = capsys.readouterr().err
    assert "pose_guider" in out["random_fill"]
    for err in (port_err, jax_err):
        assert "pose_guider: checkpoint does not cover the model, using random fill" in err
        assert "vae: no checkpoint found, using random fill" in err
    assert not torch.equal(pipe.pose_guider.conv_out.weight,
                           source[0].pose_guider.conv_out.weight.to(torch.float16).float())


# ------------------------------------------------- encoder dtypes once loaded
@pytest.mark.parametrize("which", ["wav2vec2", "wavlm"])
@torch.no_grad()
def test_loaded_audio_encoders_compute_as_jax(which):
    """The JAX package casts loaded wav2vec2 / WavLM parameters to the
    pipeline dtype (bf16) and computes in the modules' f32: the port's f32
    module holding bf16-rounded values (`load_checkpoint(value_dtype=
    torch.bfloat16)`, as `load_all_weights` loads them) gives JAX's output
    within the encoders' f32 tolerance (1e-4), and that output differs
    from the f32-parameter route by the bf16 rounding of the weights."""
    from mmgt_tpu.models.wav2vec2 import Wav2Vec2Model as JW2V
    from mmgt_tpu.models.wavlm import WavLMModel as JWavLM
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.models.wavlm import WavLMModel
    from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, load_jax_params
    from torch_port_util import close, init_noised, t

    tiny = dict(hidden_dim=32, num_layers=2, heads=4, ff_dim=64)
    wav = np.random.default_rng(20).standard_normal((1, 6400)).astype(np.float32)
    if which == "wav2vec2":
        jm, pm, args = JW2V(**tiny), lambda: Wav2Vec2Model(**tiny), (10,)
    else:
        jm, pm, args = JWavLM(num_buckets=32, max_distance=40, **tiny), lambda: WavLMModel(
            num_buckets=32, max_distance=40, **tiny), ()
    params = init_noised(jm, jnp.asarray(wav), *args, seed=21)
    f32 = load_jax_params(pm(), params, ENCODER_MAPPERS[which])
    loaded = pm()
    PC.load_checkpoint(loaded, [f32.state_dict()], value_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in loaded.parameters())
    bf16_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jm.apply(bf16_params, jnp.asarray(wav), *args)
    assert want.dtype == jnp.float32
    got = loaded(t(wav), *args)
    close(got, want, rtol=1e-4, atol=1e-4, msg=f"{which}: bf16 values, f32 compute")
    route_err = float((got - f32(t(wav), *args)).abs().max())
    print(f"{which}: max |bf16-valued - f32-valued| = {route_err:.3e}")
    assert route_err > 1e-3
