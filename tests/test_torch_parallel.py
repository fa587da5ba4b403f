"""Tensor- and data-parallel layers of the port on gloo ranks (CPU, f32),
against the JAX package's modules on the same converted weights.

Each test spawns its ranks with `torch.multiprocessing.spawn` and a
`file://` store under the test's tmp_path (no port, so nothing clashes
under xdist). The rank functions below import no JAX: the parent makes the
weights and inputs with numpy, runs the JAX reference, and hands both over
through a pickle.

  * tp = 2 (2 ranks): Attention (pre-norm K3 path with kv_lens, the
    bank both pre-projected and raw), cross-attention (multi-token and the
    one-token shortcut), FeedForward (pre-norm), AudioTransformerBlock
    with CFG-uncond rows, and MotionModule (TemporalAttention's K4 on its
    head shard, the ff and the row-parallel proj_out). The forward output
    on every rank against JAX at 1e-4 (tests/test_torch_modules.py's
    block tolerance: f32 summed in another order); the gradients of a
    random projection of the output against the unsharded port module:
    the input's whole on every rank, each parameter's this rank's slice of
    the whole gradient, rtol 1e-4 with atol 1e-4 x the largest |g|
    (f32 sums of the partials in another order).
  * dp = 2 (2 ranks): two SMGA steps on a global batch of 4, each rank
    with its 2 rows, against JAX's steps on the whole batch at
    tests/test_torch_train_stage1.py's tolerances; both ranks' weights, EMA
    and Adan state bitwise equal.
The training CLIs under the torchrun environment are in
tests/test_torch_parallel_cli.py.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from mmgt_tpu_torch.parallel.launch import spawn

HEADS = 8
C = 64


def _spawn(fn, world, tmp_path, payload):
    path = os.path.join(str(tmp_path), "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    spawn(fn, world, str(tmp_path), path, str(tmp_path))
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt")) for r in range(world)]


# ------------------------------------------------------------- the layers
def _port_layer(name):
    from mmgt_tpu_torch.models import blocks as B
    from mmgt_tpu_torch.nn.layers import Attention, FeedForward
    from mmgt_tpu_torch.utils import convert as PC

    d = C // HEADS
    where = {"attn": ("down_0_attn_0/block/attn1/",
                      "down_blocks.0.attentions.0.transformer_blocks.0.attn1."),
             "cross": ("down_0_attn_0/block/attn2/",
                       "down_blocks.0.attentions.0.transformer_blocks.0.attn2."),
             "ff": ("down_0_attn_0/block/ff/", "down_blocks.0.attentions.0.transformer_blocks.0.ff."),
             "audio": ("down_0_audio_0/block/",
                       "down_blocks.0.audio_modules.0.transformer_blocks.0."),
             "motion": ("down_0_motion_0/", "down_blocks.0.motion_modules.0.")}
    kind = LAYERS[name]
    module = {"attn": lambda: Attention(C, HEADS, d),
              "cross": lambda: Attention(C, HEADS, d, context_dim=768),
              "ff": lambda: FeedForward(C),
              "audio": lambda: B.AudioTransformerBlock(C, HEADS, d),
              "motion": lambda: B.MotionModule(C, HEADS)}[kind]()
    jp, tp_ = where[kind]

    def mapper(key):
        full = PC.map_unet3d(jp + key)
        return full[len(tp_):]
    return module, mapper


# name -> the module kind it builds
LAYERS = {"attention_bank_kv": "attn", "attention_raw_bank": "attn", "cross_attention": "cross",
          "cross_attention_one_token": "cross", "feedforward": "ff",
          "audio_block_uncond_rows": "audio", "motion_module": "motion"}


def _layer_forward(name, module, x):
    """The port call of layer `name` on inputs `x` (a dict of tensors)."""
    from mmgt_tpu_torch.nn.layers import LayerNorm, col_linear

    def ln():
        m = LayerNorm(C)
        m.weight.data.copy_(x["scale"])
        m.bias.data.copy_(x["bias"])
        return m

    if name == "attention_bank_kv":
        d = C // HEADS
        bank = x["bank"][:1]
        kb = col_linear(bank, module.to_k).reshape(1, bank.shape[1], -1, d)
        vb = col_linear(bank, module.to_v).reshape(1, bank.shape[1], -1, d)
        return module(x["x"], kv_lens=x["lens"], pre_norm=ln(), bank_kv=(kb, vb))
    if name == "attention_raw_bank":
        return module(x["x"], kv_lens=x["lens"], pre_norm=ln(), bank=x["bank"])
    if name in ("cross_attention", "cross_attention_one_token"):
        return module(x["x"], x["context"])
    if name == "feedforward":
        return module(x["x"], pre_norm=ln())
    if name == "audio_block_uncond_rows":
        return module(x["x"], x["audio"], (x["m0"], x["m1"], x["m2"]), (1.3, 0.7, 0.4), 2)
    return module(x["x"], 4)


def _layer_grads(name, module, inputs, cot):
    """(output, input gradients, parameter gradients) of <out, cot>."""
    x = {k: (v.clone().requires_grad_(v.is_floating_point() and k in ("x", "bank", "context",
                                                                        "audio"))
             ) for k, v in inputs.items()}
    out = _layer_forward(name, module, x)
    params = dict(module.named_parameters())
    wrt = [v for v in x.values() if v.requires_grad] + list(params.values())
    grads = torch.autograd.grad((out * cot).sum(), wrt, allow_unused=True)
    n_in = sum(v.requires_grad for v in x.values())
    # an input the output does not reach (the one-token shortcut's queries)
    # gets a zero gradient
    in_g = {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip([(k, v) for k, v in x.items() if v.requires_grad],
                                 grads[:n_in])}
    p_g = {k: (torch.zeros_like(p) if g is None else g)
           for (k, p), g in zip(params.items(), grads[n_in:])}
    return out.detach(), in_g, p_g


def _layers_rank(margs, payload_path, out_dir):
    torch.set_num_threads(1)
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy, local_slice, shard_
    from mmgt_tpu_torch.utils.convert import load_jax_params

    mesh = create_mesh(dp=1, tp=2, device="cpu", backend="gloo", timeout_s=120, **margs)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    out = {}
    for name, case in payload.items():
        module, mapper = _port_layer(name)
        load_jax_params(module, case["params"], mapper).eval()
        specs = shard_({"m": module}, mesh)
        inputs = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
        y, in_g, p_g = _layer_grads(name, module, inputs, torch.from_numpy(case["cot"]))
        want_p = {k: local_slice(torch.from_numpy(g), specs[f"m.{k}"], mesh)
                  for k, g in case["param_grads"].items()}
        out[name] = dict(y=y, in_g=in_g, p_g=p_g, want_p=want_p)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    destroy(mesh)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread in the parent, as tests/torch_port_util.py's
    fixture (not imported here: the ranks import this module, and that one
    imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp_layers(tmp_path_factory):
    import jax.numpy as jnp

    from mmgt_tpu.models import blocks as JB
    from mmgt_tpu.nn.layers import Attention as JAttention
    from mmgt_tpu.nn.layers import FeedForward as JFeedForward
    from mmgt_tpu_torch.utils.convert import load_jax_params
    from torch_port_util import init_noised

    rng = np.random.default_rng(0)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    d = C // HEADS
    b, l, lb = 3, 12, 10
    scale, bias = 1 + 0.1 * r(C), 0.1 * r(C)
    pre = (jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    payload, want = {}, {}
    # self-attention with K3's pre-norm, kv_lens and a batch-shared bank
    x, bank = r(b, l, C), np.repeat(r(1, lb, C), b, 0)
    lens = np.array([l, l + lb, l + lb], np.int32)
    jm = JAttention(HEADS, d)
    jargs = dict(kv_lens=jnp.asarray(lens), pre_norm=pre, bank=jnp.asarray(bank))
    params = init_noised(jm, jnp.asarray(x), **jargs)
    y = np.asarray(jm.apply(params, jnp.asarray(x), **jargs))
    for name in ("attention_bank_kv", "attention_raw_bank"):
        payload[name] = dict(params=params, inputs=dict(x=x, bank=bank, lens=lens, scale=scale,
                                                        bias=bias))
        want[name] = y
    for name, lc in (("cross_attention", 7), ("cross_attention_one_token", 1)):
        x, ctx = r(b, l, C), r(b, lc, 768)
        jm = JAttention(HEADS, d)
        params = init_noised(jm, jnp.asarray(x), jnp.asarray(ctx))
        want[name] = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
        payload[name] = dict(params=params, inputs=dict(x=x, context=ctx))
    x = r(b, l, C)
    jm = JFeedForward()
    params = init_noised(jm, jnp.asarray(x), pre_norm=pre)
    want["feedforward"] = np.asarray(jm.apply(params, jnp.asarray(x), pre_norm=pre))
    payload["feedforward"] = dict(params=params, inputs=dict(x=x, scale=scale, bias=bias))
    # the audio block: 4 rows, the first 2 CFG-uncond (zero audio tokens)
    x, audio = r(4, 16, C), r(4, 32, 768)
    audio[:2] = 0.0
    masks = tuple((rng.uniform(size=(4, 16)) > 0.4).astype(np.float32) for _ in range(3))
    ms = (1.3, 0.7, 0.4)
    jm = JB.AudioTransformerBlock(HEADS, d)
    jargs = (jnp.asarray(x), jnp.asarray(audio), tuple(map(jnp.asarray, masks)), ms, 2)
    params = init_noised(jm, *jargs)
    want["audio_block_uncond_rows"] = np.asarray(jm.apply(params, *jargs))
    payload["audio_block_uncond_rows"] = dict(
        params=params, inputs=dict(x=x, audio=audio, m0=masks[0], m1=masks[1], m2=masks[2]))
    x = r(8, 4, 4, C)
    jm = JB.MotionModule(HEADS)
    params = init_noised(jm, jnp.asarray(x), 4)
    want["motion_module"] = np.asarray(jm.apply(params, jnp.asarray(x), 4))
    payload["motion_module"] = dict(params=params, inputs=dict(x=x))
    # the unsharded port: the gradients the ranks' shards are held to
    full = {}
    for name, case in payload.items():
        case["cot"] = r(*want[name].shape)
        module, mapper = _port_layer(name)
        load_jax_params(module, case["params"], mapper).eval()
        inputs = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
        y, in_g, p_g = _layer_grads(name, module, inputs, torch.from_numpy(case["cot"]))
        case["param_grads"] = {k: g.numpy() for k, g in p_g.items()}
        full[name] = dict(y=y, in_g=in_g)
    ranks = _spawn(_layers_rank, 2, tmp_path_factory.mktemp("tp_layers"), payload)
    return dict(want=want, full=full, ranks=ranks)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", list(LAYERS))
def test_tp2_layer_matches_jax(tp_layers, name):
    for rank, res in enumerate(tp_layers["ranks"]):
        _close(res[name]["y"], tp_layers["want"][name], 1e-4, 1e-4, f"rank {rank}")


@pytest.mark.parametrize("name", list(LAYERS))
def test_tp2_layer_gradients_match_unsharded(tp_layers, name):
    full = tp_layers["full"][name]
    for rank, res in enumerate(tp_layers["ranks"]):
        got = res[name]
        for k, g in full["in_g"].items():
            _close(got["in_g"][k], g, 1e-4, 1e-4 * float(g.abs().max()), f"rank {rank} d{k}")
        assert set(got["p_g"]) == set(got["want_p"])
        scale = max(float(g.abs().max()) for g in got["want_p"].values())
        for k, g in got["p_g"].items():
            assert g.shape == got["want_p"][k].shape, k
            _close(g, got["want_p"][k], 1e-4, 1e-4 * scale, f"rank {rank} d{k}")


def test_tp2_layers_shard_their_weights(tp_layers):
    """The ranks really ran on head shards: to_q and proj_geglu hold half
    their rows, to_out.0 half its columns, a bias its whole length."""
    for res in tp_layers["ranks"]:
        g = res["attention_raw_bank"]["p_g"]
        assert tuple(g["to_q.weight"].shape) == (C // 2, C)
        assert tuple(g["to_out.0.weight"].shape) == (C, C // 2)
        assert tuple(g["to_out.0.bias"].shape) == (C,)
        g = res["feedforward"]["p_g"]
        assert tuple(g["net.0.proj.weight"].shape) == (4 * C, C)
        assert tuple(g["net.0.proj.bias"].shape) == (8 * C,)
        g = res["motion_module"]["p_g"]
        assert tuple(g["temporal_transformer.proj_out.weight"].shape) == (C, C // 2)


# ------------------------------------------------------------- SMGA at dp = 2
SMGA_KW = dict(seq_len=80, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
               cond_feature_dim=35)
SMGA_B = 4


def _smga_rank(margs, payload_path, out_dir):
    torch.set_num_threads(1)
    from mmgt_tpu_torch.models.smga import GestureDecoder
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, load_jax_params

    mesh = create_mesh(dp=2, tp=1, device="cpu", backend="gloo", timeout_s=120, **margs)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    smga = SMGA(feature_type="baseline", mesh=mesh, model=load_jax_params(
        GestureDecoder(**SMGA_KW), payload["params"], ENCODER_MAPPERS["smga"]))
    state = smga.init_state()
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    steps = []
    for draws in payload["draws"]:
        m = smga.train_step(state, batch, {k: torch.from_numpy(v) for k, v in draws.items()})
        steps.append(dict(metrics={k: v.clone() for k, v in m.items()},
                          params={n: p.detach().clone() for n, p in state.params.items()},
                          ema={n: e.clone() for n, e in state.ema.items()}))
    adan = {k: [b.clone() for b in bufs] for k, bufs in state.opt.buffers.items()}
    torch.save(dict(steps=steps, adan=adan, step=state.step),
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    destroy(mesh)


def test_smga_dp2_steps_match_jax(tmp_path):
    """Two steps on a batch of 4 split 2 + 2 over dp against JAX's two
    steps on all 4 rows; every rank ends with the same state."""
    import jax
    import jax.numpy as jnp

    from mmgt_tpu.models.smga import GestureDecoder as JGestureDecoder
    from mmgt_tpu.training.stage1 import SMGA as JSMGA
    from mmgt_tpu.training.stage1 import SMGATrainState as JState
    from mmgt_tpu_torch.models.smga import GestureDecoder
    from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, load_jax_params
    from torch_port_util import noise_params

    jsmga = JSMGA(feature_type="baseline")
    jsmga.model = JGestureDecoder(**SMGA_KW)
    params = noise_params(jax.eval_shape(
        lambda: jsmga.init_state(jax.random.PRNGKey(0), batch_size=1).params), seed=5)
    jstate = JState(jnp.zeros((), jnp.int32), params, params, jsmga.tx.init(params))
    rng = np.random.default_rng(6)
    batch = {"keypoints": rng.uniform(0, 1, (SMGA_B, 80, 402)).astype(np.float32),
             "cond_frame": rng.uniform(0, 1, (SMGA_B, 402)).astype(np.float32),
             "audio_features": rng.standard_normal((SMGA_B, 80, 35)).astype(np.float32)}

    def draws(key):
        t_rng, n_rng, d_rng = jax.random.split(key, 3)
        return {"t": np.array(jax.random.randint(t_rng, (SMGA_B,), 0, 1000)).astype(np.int64),
                "noise": np.array(jax.random.normal(n_rng, (SMGA_B, 80, 402), jnp.float32)),
                "keep": np.array(jax.random.uniform(d_rng, (SMGA_B,)) >= 0.25)}

    # keys whose cond dropout differs between the two dp halves
    keys = [k for k in (jax.random.PRNGKey(s) for s in range(200))
            if draws(k)["keep"][:2].tolist() != draws(k)["keep"][2:].tolist()][:2]
    ranks = _spawn(_smga_rank, 2, tmp_path, dict(params=params, batch=batch,
                                                  draws=[draws(k) for k in keys]))
    step = jax.jit(jsmga.train_step)
    vg = jax.jit(jax.value_and_grad(jsmga.loss_fn, has_aux=True))
    jbatch = jax.tree.map(jnp.asarray, batch)
    as_port = lambda tree: {k: v.numpy() for k, v in load_jax_params(
        GestureDecoder(**SMGA_KW), tree, ENCODER_MAPPERS["smga"]).state_dict().items()}
    lr = 2e-4
    grads_seen = []
    for i, key in enumerate(keys):
        _, jgrads = vg(jstate.params, jbatch, key)
        grads_seen.append(as_port(jgrads))
        atol = 1e-5 * max(np.abs(g).max() for g in grads_seen[-1].values())
        jstate, jm = step(jstate, jbatch, key)
        got = ranks[0]["steps"][i]
        assert set(got["metrics"]) == set(jm)
        for k, v in got["metrics"].items():
            _close(v, jm[k], 1e-5, 0, f"step {i} {k}")
        for what, want in (("params", as_port(jstate.params)),
                           ("ema", as_port(jstate.ema_params))):
            scale = max(np.abs(w).max() for w in want.values())
            held = total = 0
            for n, g in got[what].items():
                err = np.abs(g.numpy() - want[n])
                settled = np.ones_like(err, bool)
                if i:  # Adan's denominator |g + (1 - b2)(g - g_prev)|, as test_torch_train_stage1
                    g2, g1 = grads_seen[-1][n], grads_seen[-2][n]
                    settled = np.abs(g2 + 0.92 * (g2 - g1)) > 10 * atol
                assert np.isfinite(g.numpy()).all(), (what, i, n)
                assert err[settled].max(initial=0) <= 1e-6 * scale + 0.1 * lr, (what, i, n)
                held, total = held + settled.sum(), total + settled.size
            assert held >= 0.95 * total, (what, i, held / total)
    # the ranks agree bitwise: the same averaged gradients, Adan and EMA
    a, b = ranks
    assert a["step"] == b["step"] == 2
    for sa, sb in zip(a["steps"], b["steps"]):
        for what in ("params", "ema"):
            assert all(torch.equal(sa[what][n], sb[what][n]) for n in sa[what])
    for k in a["adan"]:
        assert all(torch.equal(x, y) for x, y in zip(a["adan"][k], b["adan"][k]))
