"""The port's training path against ``repro.train`` on the CPU: the XLA
attention paths, the loss and its gradients, AdamW, the train step over
several steps, microbatching, remat, gradient compression, the data
pipeline, the optimizer-state bridge and the guards that keep the kernels
(which have no backward) off the train path. Reduced olmo-1b and qwen3-8b
(GQA and qk-norm); inputs from seeded numpy, passed as numpy arrays."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as T  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-8b"]
# the MoE family: loss, aux and gradients are in test_torch_moe.py
MOE = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
# the VLM and audio families (the pipeline's batches carry the vision
# states and code frames); their loss and gradients are in
# test_torch_vlm_audio.py
MEDIA = ["llama-3.2-vision-11b", "musicgen-large"]
CPU = "cpu"
# fp32 gradients: both frameworks sum the same products in other orders;
# measured within 3.1e-6 absolute (2.5e-6 of each leaf's largest entry)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(arch):
    """Reduced config in both packages and the reference's params (numpy),
    the VLM's cross-attention gates (zero at init, so that the vision
    states would not matter) seeded in [0.5, 1.5]."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    rng = np.random.default_rng(9)

    def seed(tree):
        return {k: seed(v) if isinstance(v, dict)
                else rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                if k in ("gate_attn", "gate_mlp") else v
                for k, v in tree.items()}

    return cfg, tcfg, seed(jax.tree.map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0))))


def _batch(seed, b, s, vocab, ignore=0.2):
    """Random tokens and labels, a share ``ignore`` of the labels -100."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < ignore] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat_np(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32)
            for k, v in convert.flatten(tree).items()}


def _assert_trees_close(got, want, **tol):
    got, want = _flat_np(got), _flat_np(want)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]                      # q, k, v, cotangent


def _torch_vjp(fn, q, k, v, ct):
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(ct))
    return [t.detach().numpy() for t in (out, *grads)]


ATTENTION = {
    "chunked": (lambda q, k, v: JB.chunked_causal_attention(q, k, v,
                                                            chunk=16),
                lambda q, k, v: B.chunked_causal_attention(q, k, v,
                                                           chunk=16)),
    "full": (JB.full_causal_attention, B.full_causal_attention),
}


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("kind", sorted(ATTENTION))
def test_attention_and_grads_match_jax(kind, s):
    """Outputs and the gradients of a random cotangent, fp32: equal math in
    other summation orders, so 1e-5."""
    jfn, tfn = ATTENTION[kind]
    q, k, v, ct = _qkv(s, 2, s, 4, 16)
    out, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out, *vjp(jnp.asarray(ct))]
    for got, w in zip(_torch_vjp(tfn, q, k, v, ct), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(1040, 512), (1025, 512), (37, 16)])
def test_chunked_attention_matches_full_at_any_length(s, chunk):
    """The port's chunked attention against its full attention, outputs and
    gradients, fp32. 1040 splits into the reference's two 520-key chunks;
    1025 and 37 leave a short last chunk, where the reference's reshape
    fails (see the next test)."""
    q, k, v, ct = _qkv(s, 1, s, 2, 16)
    got = _torch_vjp(lambda *a: B.chunked_causal_attention(*a, chunk=chunk),
                     q, k, v, ct)
    want = _torch_vjp(B.full_causal_attention, q, k, v, ct)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_reference_chunked_attention_fails_at_ragged_length():
    q = jnp.zeros((1, 1025, 2, 16))
    with pytest.raises(TypeError, match="reshape"):
        JB.chunked_causal_attention(q, q, q)


def test_gqa_expand_matches_jax():
    k = np.random.default_rng(0).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        B._gqa_expand(torch.from_numpy(k), 8).numpy(),
        np.asarray(JB._gqa_expand(jnp.asarray(k), 8)))


def test_bf16_logit_blocks_follow_attn_impl():
    """"xla-bf16-logits" takes bf16 score blocks above 1024 keys: bf16
    scores differ from fp32 ones, but by no more than bf16 rounding."""
    q, k, v, _ = _qkv(3, 1, 1040, 2, 16)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    fp32 = B.train_attention(q, k, v, 2, "xla").float()
    bf16 = B.train_attention(q, k, v, 2, "xla-bf16-logits").float()
    assert not torch.equal(fp32, bf16)
    np.testing.assert_allclose(bf16.numpy(), fp32.numpy(), rtol=0,
                               atol=5e-2 * fp32.abs().max().item())


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _loss_and_grads(arch, b, s, compute_dtype="float32", seed=0, **tkw):
    cfg, tcfg, params = _params(arch)
    batch = _batch(seed, b, s, cfg.vocab_size)
    jtc = JT.TrainConfig(remat="none", compute_dtype=compute_dtype, **tkw)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(cfg, jtc), has_aux=True))(_j(params), _j(batch))
    grad_fn = T.make_grad_fn(tcfg, T.TrainConfig(
        remat="none", compute_dtype=compute_dtype, **tkw), device=CPU)
    tl, tm, tg = grad_fn(convert.from_numpy(params), _t(batch))
    return (float(jl), jm, jax.tree.map(np.asarray, jg)), (float(tl), tm, tg)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 1040)])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, b, s):
    """fp32 loss and gradients against ``jax.value_and_grad`` of the
    reference's loss, a fifth of the labels -100; S = 32 takes full
    attention, S = 1040 the chunked one."""
    (jl, jm, jg), (tl, tm, tg) = _loss_and_grads(arch, b, s)
    assert tl == pytest.approx(jl, rel=1e-6)
    assert int(tm["ntokens"]) == int(jm["ntokens"]) < b * s
    assert float(tm["aux_loss"]) == 0.0
    _assert_trees_close(tg, jg, **GRAD_TOL)


def test_loss_ignores_all_labels_like_the_reference():
    """No valid label: ntokens is clamped to 1 and the loss is 0."""
    cfg, tcfg, params = _params("olmo-1b")
    batch = _batch(1, 2, 8, cfg.vocab_size, ignore=1.0)
    ctx = JM.make_ctx(cfg, 8, "train", remat=None, compute_dtype=jnp.float32)
    jl, jm = JM.loss_fn(_j(params), _j(batch), cfg, ctx)
    tctx = M.make_ctx(tcfg, 8, "train", remat=None,
                      compute_dtype=torch.float32, device=CPU)
    tl, tm = M.loss_fn(convert.from_numpy(params), _t(batch), tcfg, tctx)
    assert float(tl) == float(jl) == 0.0
    assert int(tm["ntokens"]) == int(jm["ntokens"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_jax(arch):
    """bf16 compute: both frameworks round activations to 8 bits of
    mantissa at places that differ, and the loss averages that rounding
    over the tokens. Each bf16 loss is within 1e-3 of the fp32 loss,
    relative, and so within 2e-3 of the other (measured: at most 1.1e-4
    from fp32 for either)."""
    for s in (32, 1040):
        (jl, _, _), (tl, _, _) = _loss_and_grads(arch, 1, s, "bfloat16")
        (fp32, _, _), _ = _loss_and_grads(arch, 1, s)
        assert abs(jl - fp32) <= 1e-3 * abs(fp32)
        assert abs(tl - fp32) <= 1e-3 * abs(fp32)


def test_param_stream_dtype_grads_match_jax():
    """fp32 params cast to bf16 once per step: the gradients reach the fp32
    params through the cast. bf16 gradients from two frameworks that round
    at different places: within 5e-2 of each leaf's largest entry
    (measured at most 3.3e-2)."""
    (jl, _, jg), (tl, _, tg) = _loss_and_grads(
        "qwen3-8b", 2, 32, "bfloat16", param_stream_dtype="bfloat16")
    assert abs(tl - jl) <= 1e-3 * abs(jl)
    got, want = _flat_np(tg), _flat_np(jg)
    for key, w in want.items():
        assert tg is not None and convert.flatten(tg)[key].dtype == \
            torch.float32, key
        if w.size:
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=5e-2 * np.abs(w).max(),
                                       err_msg=key)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    cfg = O.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    jcfg = JO.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_frac=0.1)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    got = [float(O.schedule(cfg, torch.tensor(s))) for s in steps]
    want = [float(JO.schedule(jcfg, jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and got[-1] == pytest.approx(0.1)


def _grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), params)


def test_global_norm_matches_reference():
    _, _, params = _params("qwen3-8b")
    grads = _grads_like(params, 0)
    got = float(O.global_norm(convert.from_numpy(grads)))
    assert got == pytest.approx(float(JO.global_norm(_j(grads))), rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e4])
@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_reference(master, clip):
    """The same numpy grads in, one and then three updates, rtol 1e-6, with
    weight decay (the stacked norms and qk-norms decay, final_norm does
    not), clipping active (clip 1) or not, and with or without fp32 master
    weights under bf16 params. Near zero, rtol gives way to 1e-6 of an
    update of size lr: the global norm and the bias corrections are summed
    and raised in another order, and p - lr * delta rounds at the update's
    scale (measured: at most 5e-9 at lr 1e-2). bf16 params are held to be
    the bf16 cast of the fp32 masters."""
    _, _, params = _params("qwen3-8b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=clip)
    cfg, jcfg = O.OptimizerConfig(**kw), JO.OptimizerConfig(**kw)
    jp, tp = _j(params), convert.from_numpy(params)
    if master:
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
        tp = O.tree_map(lambda p: p.to(torch.bfloat16), tp)
    jstate = JO.init_opt_state(jp, master_weights=master)
    tstate = O.init_opt_state(tp, master_weights=master)
    for i in range(3):
        grads = _grads_like(params, i, scale=0.1)
        jp, jstate, jm = JO.adamw_update(jcfg, jp, _j(grads), jstate)
        tp, tstate, tm = O.adamw_update(cfg, tp, convert.from_numpy(grads),
                                        tstate)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if i in (0, 2):
            for key in ("mu", "nu") + (("master",) if master else ()):
                _assert_trees_close(tstate[key], jstate[key], rtol=1e-6,
                                    atol=1e-6 * kw["lr"])
            if master:
                masters = convert.flatten(tstate["master"])
                for key, t in convert.flatten(tp).items():
                    assert t.dtype == torch.bfloat16, key
                    assert torch.equal(t, masters[key].bfloat16()), key
            else:
                _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-6 * kw["lr"])
            assert int(tstate["step"]) == int(jstate["step"]) == i + 1


def test_weight_decay_follows_leaf_rank():
    """Zero gradients: only the decay moves a param. The stacked (L, d)
    norm scales and (L, hd) qk-norms decay; final_norm (d,) does not."""
    _, _, params = _params("qwen3-8b")
    cfg = O.OptimizerConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    tp = convert.from_numpy(params)
    zeros = O.tree_map(torch.zeros_like, tp)
    tp, _, _ = O.adamw_update(cfg, tp, zeros, O.init_opt_state(tp))
    new = convert.flatten(tp)
    old = convert.flatten(convert.from_numpy(params))
    for key in ("layers/ln1/scale", "layers/attn/q_norm", "layers/attn/wq"):
        assert new[key].dim() >= 2 and not torch.equal(new[key], old[key])
    assert torch.equal(new["final_norm/scale"], old["final_norm/scale"])


def test_clipping_reports_norm_before_clip():
    params = {"w": torch.zeros(3)}
    cfg = O.OptimizerConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    _, _, m = O.adamw_update(cfg, params, {"w": torch.full((3,), 1e6)},
                             O.init_opt_state(params))
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(3) * 1e6)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _pipe(cfg, b=4, s=32, vocab=32):
    return JP.TokenPipeline(JP.DataConfig(vocab_size=vocab, seq_len=s,
                                          global_batch=b, markov_temp=2.5),
                            cfg)


def _run_both(arch, steps, lr=1e-3, batch_fn=None, **tkw):
    """``steps`` train steps of both packages from the same params and
    batches (fp32 compute). Returns (jax params, jax state, torch params,
    torch state, per-step (jax, torch) metrics)."""
    cfg, tcfg, params = _params(arch)
    tkw = {"remat": "none", "compute_dtype": "float32", **tkw}
    okw = dict(lr=lr, warmup_steps=0, total_steps=100, weight_decay=0.1)
    jtc, ttc = JT.TrainConfig(**tkw), T.TrainConfig(**tkw)
    jstep = jax.jit(JT.make_train_step(cfg, jtc, JO.OptimizerConfig(**okw)))
    tstep = T.make_train_step(tcfg, ttc, O.OptimizerConfig(**okw),
                              device=CPU)
    jp, tp = _j(params), convert.from_numpy(params)
    js, ts = JT.make_opt_state(jp, jtc), T.make_opt_state(tp, ttc)
    pipe = _pipe(cfg)
    metrics = []
    for i in range(steps):
        batch = batch_fn(i) if batch_fn else pipe.batch_at(i)
        jp, js, jm = jstep(jp, js, _j(batch))
        tp, ts, tm = tstep(tp, ts, batch)
        metrics.append((jm, tm))
    return jp, js, tp, ts, metrics


@pytest.mark.parametrize("arch", ARCHS + MOE + MEDIA)
def test_train_step_matches_reference_after_3_steps(arch):
    """Params and optimizer state after 3 AdamW steps (lr 1e-3, fp32).
    AdamW's first steps move each weight by about lr * sign(g): where |g|
    is near zero, fp32 noise between the frameworks can flip that sign, so
    a param may differ by up to 2 lr per step. The params are held to 6 lr
    = 6e-3 absolute over 3 steps, and all but 1e-3 of their entries to
    1e-5; the moments, which carry no sign, at the gradients' tolerance."""
    jp, js, tp, ts, metrics = _run_both(arch, 3)
    for jm, tm in metrics:
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    got, want = _flat_np(tp), _flat_np(jax.tree.map(np.asarray, jp))
    for key, w in want.items():
        err = np.abs(got[key] - w)
        assert err.max(initial=0) <= 6e-3, key
        assert (err > 1e-5).mean() <= 1e-3 if w.size else True, key
    for key in ("mu", "nu"):
        _assert_trees_close(ts[key], js[key], **GRAD_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("uneven", [False, True])
def test_microbatches_mean_the_per_microbatch_means(uneven):
    """microbatches=2: loss and grads are the mean of the two halves' own
    means, summed in fp32. With as many valid labels in each half this is
    the full batch's mean (microbatches=1); with an uneven -100 split it
    is not, and it is what the reference's step computes (held after one
    step of both packages)."""
    cfg, tcfg, params = _params("olmo-1b")
    batch = _pipe(cfg).batch_at(0)
    if uneven:
        batch["labels"][:2, :20] = -100            # the first half loses more
    tb = _t(batch)
    tp = convert.from_numpy(params)

    def grads(k, b):
        fn = T.make_grad_fn(tcfg, T.TrainConfig(
            microbatches=k, remat="none", compute_dtype="float32"), device=CPU)
        return fn(tp, b)

    loss2, m2, g2 = grads(2, tb)
    halves = [grads(1, {k: v[i:i + 2] for k, v in tb.items()})
              for i in (0, 2)]
    mean = O.tree_map(lambda a, b: (a + b) / 2, halves[0][2], halves[1][2])
    _assert_trees_close(g2, mean, rtol=1e-6, atol=1e-9)
    assert float(loss2) == pytest.approx(
        (float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-6)
    assert int(m2["ntokens"]) == int(halves[1][1]["ntokens"])  # the last
    loss1, _, g1 = grads(1, tb)
    if uneven:
        assert abs(float(loss2) - float(loss1)) > 1e-3
        jp, _, tp2, _, _ = _run_both("olmo-1b", 1, batch_fn=lambda i: batch,
                                     microbatches=2)
        _assert_trees_close(tp2, jax.tree.map(np.asarray, jp), rtol=0,
                            atol=2e-3)
    else:
        assert float(loss2) == pytest.approx(float(loss1), rel=1e-5)
        _assert_trees_close(g2, g1, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS + MOE)
def test_remat_policies_give_equal_grads(arch):
    """remat none, full and dots recompute the same ops on the same inputs:
    equal gradients within 1e-6 of each leaf's largest entry (autograd may
    sum a tied weight's two gradients in another order once layers are
    recomputed; at these shapes they come out bit for bit)."""
    cfg, tcfg, params = _params(arch)
    batch = _t(_batch(2, 2, 24, cfg.vocab_size))
    tp = convert.from_numpy(params)
    out = {}
    for remat in ("none", "full", "dots"):
        fn = T.make_grad_fn(tcfg, T.TrainConfig(
            remat=remat, compute_dtype="float32"), device=CPU)
        out[remat] = _flat_np(fn(tp, batch)[2])
    for remat in ("full", "dots"):
        for key, want in out["none"].items():
            np.testing.assert_allclose(
                out[remat][key], want, rtol=0, err_msg=f"{remat} {key}",
                atol=1e-6 * np.abs(want).max(initial=0))


def test_dots_policy_saves_matmuls_and_full_recomputes_them():
    """Counting ``aten.mm`` over a forward and backward: "dots" runs as
    many as no remat (the layers' matmul outputs are saved); "full" runs
    each layer's forward matmuls again up to the last one its backward
    needs, 6 of 7 (the recompute stops early, and the w_down product's
    output is saved by nothing in the layer); both recompute the batched
    attention products (``aten.bmm``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    cfg, tcfg, params = _params("olmo-1b")
    batch = _t(_batch(3, 1, 16, cfg.vocab_size))
    counts = {}
    for remat in ("none", "full", "dots"):
        fn = T.make_grad_fn(tcfg, T.TrainConfig(
            remat=remat, compute_dtype="float32"), device=CPU)
        with Count() as c:
            fn(convert.from_numpy(params), batch)
        counts[remat] = c.n
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["full"]["mm"] == counts["none"]["mm"] + 6 * cfg.n_layers
    assert counts["dots"]["bmm"] == counts["full"]["bmm"] \
        > counts["none"]["bmm"]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compression_with_feedback_matches_reference(kind):
    """The same numpy grads and residuals through both packages' error
    feedback: equal dequantized grads and residuals (int8 rounds half to
    even in both)."""
    _, _, params = _params("qwen3-8b")
    grads = _grads_like(params, 5, scale=0.3)
    res = _grads_like(params, 6, scale=1e-3)
    jg, jr = JC.compress_grads_with_feedback(_j(grads), _j(res), kind)
    tg, tr = C.compress_grads_with_feedback(convert.from_numpy(grads),
                                            convert.from_numpy(res), kind)
    _assert_trees_close(tg, jax.tree.map(np.asarray, jg), rtol=1e-6,
                        atol=1e-9)
    _assert_trees_close(tr, jax.tree.map(np.asarray, jr), rtol=1e-6,
                        atol=1e-9)


def test_int8_compress_rounds_half_to_even_and_floors_scale():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])
    q, scale = C.compress(g, "int8")
    assert float(scale) == pytest.approx(1.0)
    assert q.tolist() == [0, 2, 2, 0, 127]
    q0, s0 = C.compress(torch.zeros(4), "int8")
    assert float(s0) == pytest.approx(1e-12 / 127) and not q0.any()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_train_step_compression_residuals_match_reference(kind):
    """Two steps with compressed gradients: residuals and params against
    the reference's. The residuals are the quantization error of grads
    that agree to the gradients' tolerance, but a value within that
    tolerance of a rounding edge may round the other way in the other
    package, which moves its residual by one quantization step: the int8
    scale, or the value's bf16 ulp. A step is at most about twice the
    leaf's largest residual, so each entry is held to 2.5 max|r|, and at
    most 0.1% of the entries may differ by more than 1e-6 (measured: at
    most 0.052%). The params at 4 lr, two steps' sign flips."""
    jp, js, tp, ts, _ = _run_both("olmo-1b", 2, grad_compression=kind)
    got = _flat_np(ts["residuals"])
    want = _flat_np(jax.tree.map(np.asarray, js["residuals"]))
    assert list(got) == list(want)
    for key, w in want.items():
        err = np.abs(got[key] - w)
        assert err.max(initial=0) <= 2.5 * np.abs(w).max(initial=0), key
        assert (err > 1e-6).mean() <= 1e-3 if w.size else True, key
    _assert_trees_close(tp, jax.tree.map(np.asarray, jp), rtol=0, atol=4e-3)


def test_loss_decreases_over_25_steps():
    """As tests/test_train.py: the port's step on the reference's tiny
    setup (lr 3e-3, warmup 5) learns the synthetic chain."""
    cfg, tcfg, params = _params("olmo-1b")
    tc = T.TrainConfig()
    step = T.make_train_step(tcfg, tc, O.OptimizerConfig(
        lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0),
        device=CPU)
    tp = convert.from_numpy(params)
    opt = T.make_opt_state(tp, tc)
    pipe = P.TokenPipeline(P.DataConfig(vocab_size=32, seq_len=32,
                                        global_batch=16, markov_temp=2.5),
                           tcfg)
    losses = []
    for i in range(25):
        tp, opt, metrics = step(tp, opt, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses


def test_master_weights_train_step_matches_reference():
    """bf16 params with fp32 masters, one step: the masters against the
    reference's at the tolerance of a sign flip (2 lr), and the params are
    the masters' bf16 cast."""
    cfg, tcfg, params = _params("olmo-1b")
    tkw = dict(remat="none", master_weights=True)
    okw = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    jtc, ttc = JT.TrainConfig(**tkw), T.TrainConfig(**tkw)
    jp = jax.tree.map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), params)
    tp = O.tree_map(lambda p: p.to(torch.bfloat16),
                    convert.from_numpy(params))
    js, ts = JT.make_opt_state(jp, jtc), T.make_opt_state(tp, ttc)
    batch = _pipe(cfg).batch_at(0)
    jp, js, _ = jax.jit(JT.make_train_step(cfg, jtc, JO.OptimizerConfig(
        **okw)))(jp, js, _j(batch))
    tp, ts, _ = T.make_train_step(tcfg, ttc, O.OptimizerConfig(**okw),
                                  device=CPU)(tp, ts, batch)
    _assert_trees_close(ts["master"], js["master"], rtol=0, atol=2e-3)
    for key, t in convert.flatten(tp).items():
        assert t.dtype == torch.bfloat16, key
        assert torch.equal(t, convert.flatten(ts["master"])[key].to(
            torch.bfloat16)), key


# ---------------------------------------------------------------------------
# data, convert, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,host", [(1, 0), (2, 1)])
def test_token_pipeline_matches_reference(n_hosts, host):
    kw = dict(seed=7, vocab_size=64, seq_len=16, global_batch=8,
              n_hosts=n_hosts, host_index=host)
    ref = JP.TokenPipeline(JP.DataConfig(**kw), get_arch("olmo-1b"))
    ours = P.TokenPipeline(P.DataConfig(**kw), port_arch("olmo-1b"))
    for step in (0, 3):
        want, got = ref.batch_at(step), ours.batch_at(step)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_token_pipeline_registers_like_the_reference():
    class Project:
        def __init__(self):
            self.calls = []

        def upload(self, *args):
            self.calls.append(("upload", args))

        def create_file_set(self, *args):
            self.calls.append(("create_file_set", args))
            return f"{args[0]}:1"

    cfg = dict(seed=3, vocab_size=16)
    ref, ours = Project(), Project()
    want = JP.TokenPipeline(JP.DataConfig(**cfg)).register(ref, "d", "me")
    got = P.TokenPipeline(P.DataConfig(**cfg)).register(ours, "d", "me")
    assert got == want and ours.calls == ref.calls


@pytest.mark.parametrize("tkw", [{}, {"master_weights": True},
                                 {"grad_compression": "int8"}])
def test_opt_state_bridge_round_trips_bit_exact(tkw):
    """A reference optimizer state after one step -> port tensors -> numpy
    is bit-exact, and the port's own state after a step -> numpy -> port
    tensors is too."""
    cfg, tcfg, params = _params("olmo-1b")
    jp = _j(params)
    if tkw.get("master_weights"):
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
    jtc = JT.TrainConfig(remat="none", **tkw)
    _, js, _ = jax.jit(JT.make_train_step(cfg, jtc, JO.OptimizerConfig()))(
        jp, JT.make_opt_state(jp, jtc), _j(_pipe(cfg).batch_at(0)))
    ref = jax.tree.map(np.asarray, js)
    ours = convert.opt_state_from_numpy(ref)
    back = convert.opt_state_to_numpy(ours)
    assert sorted(back) == sorted(ref)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 1
    for key in ref:
        if key == "step":
            continue
        want, got = convert.flatten(ref[key]), convert.flatten(back[key])
        assert list(got) == list(want)
        for path, a in want.items():
            np.testing.assert_array_equal(got[path].view(np.uint32),
                                          a.view(np.uint32), err_msg=path)
    again = convert.opt_state_from_numpy(back)
    for key in ours:
        for path, t in convert.flatten(ours[key] if key != "step" else
                                       {"s": ours[key]}).items():
            other = convert.flatten(again[key] if key != "step" else
                                    {"s": again[key]})[path]
            assert torch.equal(t, other) and t.dtype == other.dtype, path


def test_opt_state_bridge_refuses_bad_entries():
    state = convert.opt_state_to_numpy(O.init_opt_state({"w": torch.ones(2)}))
    with pytest.raises(TypeError):
        convert.opt_state_from_numpy({**state, "step": np.int64(0)})
    with pytest.raises(KeyError):
        convert.opt_state_from_numpy({**state, "moment3": {}})


def test_launch_train_main_on_cpu(capsys, tmp_path):
    losses = LT.main(["--device", "cpu", "--steps", "3", "--seq-len", "16",
                      "--global-batch", "4", "--workdir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "olmo-1b-smoke on cpu: loss" in out
    assert out.strip().splitlines()[-1] == "done: 3 steps, 1 ckpts, latest=3"


def test_launch_train_refuses_mesh():
    """--mesh runs (tests/test_torch_mesh_launch.py); the meshes it cannot
    run are refused before any rank starts: nccl on the CPU, and a mesh
    of three axes."""
    with pytest.raises(RuntimeError, match="--backend gloo"):
        LT.main(["--device", "cpu", "--mesh", "2x2", "--backend", "nccl"])
    with pytest.raises(ValueError, match="mesh"):
        LT.main(["--device", "cpu", "--mesh", "2x2x2"])


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "pallas-interpret"])
def test_kernel_attn_impl_raises_in_train_mode(impl):
    cfg, tcfg, params = _params("olmo-1b")
    fn = T.make_grad_fn(tcfg, T.TrainConfig(attn_impl=impl, remat="none"),
                        device=CPU)
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(convert.from_numpy(params), _t(_batch(0, 1, 8, cfg.vocab_size)))


def test_cut_graph_raises_instead_of_zero_grads(monkeypatch):
    """An attention whose output has no grad_fn (as a kernel's would) cuts
    wq, wk, wv and the qk-norms off the loss: the step names them."""
    real = B.train_attention
    monkeypatch.setattr(B, "train_attention",
                        lambda *a: real(*a).detach())
    cfg, tcfg, params = _params("qwen3-8b")
    fn = T.make_grad_fn(tcfg, T.TrainConfig(remat="none"), device=CPU)
    with pytest.raises(RuntimeError, match="layers/attn/wq") as err:
        fn(convert.from_numpy(params), _t(_batch(0, 1, 8, cfg.vocab_size)))
    assert "layers/attn/q_norm" in str(err.value)
    assert "layers/attn/wo" not in str(err.value)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-7b", "zamba2-7b"])
def test_train_path_reaches_no_kernel_wrapper(arch, monkeypatch):
    """Train mode on the CPU never calls a kernel wrapper (on the card they
    would launch kernels without a backward): the dense, rwkv and hybrid
    layouts take their own attention and scans."""
    from repro_torch.kernels import ops

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called in train mode")

    for name in ("flash_attention", "decode_attention", "wkv6",
                 "mamba2_ssd"):
        monkeypatch.setattr(ops, name, boom)
    cfg, tcfg, params = _params(arch)
    fn = T.make_grad_fn(tcfg, T.TrainConfig(remat="dots"), device=CPU)
    loss, _, _ = fn(convert.from_numpy(params),
                    _t(_batch(0, 1, 1040, cfg.vocab_size)))
    assert np.isfinite(float(loss))


def test_reference_train_defaults_are_kept():
    assert dataclasses.asdict(T.TrainConfig()) == dataclasses.asdict(
        JT.TrainConfig())
    assert dataclasses.asdict(O.OptimizerConfig()) == dataclasses.asdict(
        JO.OptimizerConfig())
