"""LM wrapper (the port of ``repro/models/model.py``): embedding, block stack,
tied or untied head, the next-token loss, prefill and decode entries."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import is_fake
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd as S

# leaves the reference reads in fp32 (norms, the RWKV bonus, decay base and
# group-norm scale, the Mamba A_log, D, dt_bias and gated-norm scale, the
# cross-attention layers' tanh gates)
FP32_KEYS = ("ln1", "ln2", "final_norm", "bonus_u", "decay_base", "ln_x",
             "A_log", "D", "dt_bias", "gate_norm", "gate_attn", "gate_mlp")
# leaves kept fp32 at one place of the tree: the VLM's cross-attention K/V
# projections, from which the decode state builds the vision K/V in the
# vision's own dtype (the reference's cross_state multiplies fp32 vision
# states by its fp32 wk and wv); prefill and training cast them per call
FP32_PATHS = (("layers", "single", "attn", "wk"),
              ("layers", "single", "attn", "wv"))


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32):
    """Params from a seeded ``torch.Generator`` on ``device``, with the
    reference's structure, shapes and init scales (not its random bits).
    With codebooks (K = ``n_codebooks``) the embedding is (K, V, d) and the
    head (d, K V), its columns codebook-major.

    ``dtype`` only chooses the leaves' storage: the tree is the one that
    ``cast_params`` makes, its leaves of ``FP32_KEYS`` and ``FP32_PATHS``
    fp32 and the others ``dtype``. Every leaf is drawn in fp32 and cast
    alone, a stacked one a layer at a time (``transformer.init_stack``),
    so the draws are the same for every ``dtype``
    (``init_params(cfg, dtype=torch.bfloat16)`` is ``cast_params(
    init_params(cfg), torch.bfloat16)`` bit for bit) and no fp32 tree
    exists: qwen3-32b's 65.5 GB of bf16 weights are made on one 80 GB
    card, where its 131 GB fp32 tree is not. The embedding and the head
    are drawn before the layers, so a model cut to fewer layers has the
    same embedding, head and first layers as the whole model."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()

    def dtype_of(path):
        return torch.float32 if stays_fp32(path) else dtype

    params = {"embed": torch.randn((*books, cfg.vocab_size, cfg.d_model),
                                   generator=gen, device=dev).mul_(0.02)
              .to(dtype),
              "final_norm": B.init_norm(cfg, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = B.dense_init(
            gen, (cfg.d_model, (cfg.n_codebooks or 1) * cfg.vocab_size)
        ).to(dtype)
    params.update(T.init_stack(cfg, gen, dtype_of))
    return params


def stays_fp32(path: tuple) -> bool:
    """Whether the subtree or leaf at ``path`` (keys from the tree's root)
    stays fp32 in a tree cast to a compute dtype: under a key of
    ``FP32_KEYS`` (``ln1`` holds ``scale``) or at a path of
    ``FP32_PATHS``."""
    path = tuple(path)
    return any(k in FP32_KEYS for k in path) or \
        any(path[:i] in FP32_PATHS for i in range(1, len(path) + 1))


def param_shapes(cfg: ArchConfig):
    """The param tree's leaf shapes (``torch.Size``), from ``init_params``
    under fake tensors: nothing is allocated, so the 32 B configs'
    shapes come as cheaply as the reduced ones'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init_params(cfg, 0, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else v.shape
                for k, v in tree.items()}
    return shapes(params)


def cast_params(params, dtype):
    """Cast the weights that the blocks cast per call (``.to(cd)``) once, at
    load. The values are those of the reference's per-call ``.astype(cd)``;
    the leaves of ``FP32_KEYS`` and ``FP32_PATHS`` stay fp32, since the
    reference reads them in fp32 (casting them would change their values).
    The tree itself takes the cast leaves, each fp32 leaf dropped as soon
    as it is cast, so that the peak holds one tree and one leaf, not both
    trees (llama-3.2-vision-11b's fp32 weights take 39.8 GB); the tree is
    returned."""
    def cast(tree, path):
        for key, val in tree.items():
            at = (*path, key)
            if stays_fp32(at):
                continue
            tree[key] = cast(val, at) if isinstance(val, dict) \
                else val.to(dtype)
        return tree
    return cast(params, ())


def make_ctx(cfg: ArchConfig, seq_len: int, mode: str, *,
             attn_impl: str = "xla", remat: str | None = "full",
             vision=None, cache_len=None, compute_dtype=torch.bfloat16,
             device="cuda", mesh=None) -> dict:
    """RoPE table of ``seq_len`` rows (none for an attention-free config),
    the vision states (B, Nv, d_src) that the VLM's cross-attention reads
    in prefill and training, moved to the device, and, for decode, the
    positions ``cache_len[:, None]``. A position past
    the table would read outside it (the reference's ``jnp.take`` gives NaN
    there), so it raises here (a fake ``cache_len`` is not read).
    ``attn_impl`` and ``remat`` are read in "train" mode only
    (``blocks.train_attention``, ``transformer._maybe_remat``); prefill and
    decode run the kernels.
    ``mesh``: a ``spmd.MeshCtx`` when the params are this rank's shards
    and the batch its rows (the sharded steps), else None; it carries the
    KV caches' sequence layout (``MeshCtx.kv_seq_axes``) to every
    attention layer of the stack (the uniform layers, the hybrid's shared
    block, the VLM's self-attention layers), while ``positions`` and the
    buffer check here stay global."""
    dev = resolve_device(device)
    ctx = {"mode": mode, "attn_impl": attn_impl, "remat": remat,
           "compute_dtype": compute_dtype, "mesh": mesh}
    if not cfg.attention_free:
        ctx["rope"] = B.rope_table(seq_len, cfg.resolved_head_dim,
                                   cfg.rope_theta, device=dev)
    if vision is not None:
        ctx["vision"] = torch.as_tensor(vision, device=dev)
    if cache_len is not None:
        # a dry-run's fake cache_len holds no value to check (reading one
        # raises there); the card's steps check every real one
        if cache_len.numel() and not is_fake(cache_len) \
                and int(cache_len.max()) >= seq_len:
            raise IndexError(f"decode position {int(cache_len.max())} is "
                             f"past the buffer of {seq_len}")
        ctx["cache_len"] = cache_len
        ctx["positions"] = cache_len[:, None].long()
    return ctx


def embed_tokens(params, tokens, cfg: ArchConfig, compute_dtype, mesh=None):
    """Embedding rows of tokens (B, S) in the compute dtype. With codebooks,
    tokens (B, S, K) and the sum over k of ``embed[k][tokens[..., k]]``:
    the reference's one-hot einsum, whose bf16 form rounds the table to
    bf16 and the fp32 sum once; the port gathers the rows instead of
    building the one-hot, and rounds where the einsum does. On a mesh a
    tied table holds this rank's vocab rows (a token of another rank's
    rows reads zeros, and the sum over the model axis has each row once)
    and an untied one, the codebooks' (K, V, d) table included, its
    d_model columns (gathered). FSDP never shards the table
    (``param_specs`` skips it)."""
    if cfg.n_codebooks:
        books = torch.arange(cfg.n_codebooks, device=tokens.device)
        rows = params["embed"][books, tokens].to(compute_dtype)  # (B, S, K, d)
        return S.tp_gather(rows.float().sum(-2).to(compute_dtype), mesh, -1)
    if mesh is not None and mesh.tp > 1:
        table = params["embed"]
        if not cfg.tie_embeddings:
            return S.tp_gather(table[tokens].to(compute_dtype), mesh, -1)
        v0 = mesh.tp_rank * table.shape[0]
        mine = (tokens >= v0) & (tokens < v0 + table.shape[0])
        rows = table[torch.where(mine, tokens - v0, 0)].to(compute_dtype)
        return S.tp_reduce(rows * mine[..., None], mesh)
    return params["embed"][tokens].to(compute_dtype)


def lm_logits(params, x, cfg: ArchConfig, mesh=None, gather: bool = True):
    """Logits (B, S, V), or (B, S, K, V) with codebooks (the head's columns
    codebook-major, as in the reference). On a mesh the head is
    vocab-sharded (``lm_head`` is in ``_COL_TP``, a tied table in its vocab
    rows) and this rank's columns are gathered whole, for greedy decoding;
    with ``gather`` False (the loss, ``vocab_sharded_nll``) a rank keeps
    its own columns, (B, S, K V / tp) flat, codebooks or not. An untied
    head that FSDP shards is gathered over data here, once a call."""
    xf = S.tp_copy(B.apply_norm(params["final_norm"], x, cfg), mesh)
    w = params["embed"].t() if cfg.tie_embeddings else \
        S.gather_params(params["lm_head"], mesh, "lm_head")
    logits = xf @ w.to(xf.dtype)
    if not gather and mesh is not None and mesh.tp > 1:
        return logits
    logits = S.tp_gather(logits, mesh, -1)
    if cfg.n_codebooks:
        logits = logits.unflatten(-1, (cfg.n_codebooks, cfg.vocab_size))
    return logits


class _VocabShardedNLL(torch.autograd.Function):
    """logz - gold of each row and codebook from this rank's vocab columns
    of the fp32 logits, as the reference's partitioner computes it: the
    row's max all-reduced (MAX) over the model group and held constant,
    the sum of exp(l - max) and the gold logit (read on the rank whose
    columns hold the label, zero elsewhere) all-reduced (SUM) in one call.
    Backward: softmax - onehot at this rank's columns times the upstream
    gradient, and no collective: every model rank holds the same loss, so
    a summing backward (``spmd.tp_sum``'s) would scale the head's gradient
    by the model axis' size."""

    @staticmethod
    def forward(ctx, logits, labels, vocab, col0, group):
        # logits (..., C): global columns [col0, col0 + C), codebook-major
        # over K codebooks of ``vocab``; labels (..., K) vocab ids
        c, k = logits.shape[-1], labels.shape[-1]
        spans = [(min(max(i * vocab - col0, 0), c),
                  min(max((i + 1) * vocab - col0, 0), c)) for i in range(k)]
        mine = [i for i, (a, b) in enumerate(spans) if a < b]
        m = logits.new_full(labels.shape, float("-inf"))
        for i in mine:
            a, b = spans[i]
            m[..., i] = logits[..., a:b].amax(-1)
        m = S.all_reduce(m, group, op=torch.distributed.ReduceOp.MAX)
        local = labels + torch.tensor([i * vocab - col0 for i in range(k)],
                                      device=labels.device)
        held = (local >= 0) & (local < c)
        idx = local.clamp(0, c - 1)
        parts = logits.new_zeros((2, *labels.shape))
        for i in mine:
            a, b = spans[i]
            parts[0, ..., i] = torch.sub(logits[..., a:b],
                                         m[..., i:i + 1]).exp_().sum(-1)
        parts[1] = torch.where(held, logits.gather(-1, idx), 0.0)
        parts = S.all_reduce(parts, group)
        logz = m + torch.log(parts[0])
        ctx.save_for_backward(logits, logz, idx, held)
        ctx.spans = spans
        return logz - parts[1]

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, held = ctx.saved_tensors
        grad = torch.empty_like(logits)      # every column is in one span
        for i, (a, b) in enumerate(ctx.spans):
            if a < b:
                part = grad[..., a:b]
                torch.sub(logits[..., a:b], logz[..., i:i + 1], out=part)
                part.exp_().mul_(g[..., i:i + 1])
        grad.scatter_add_(-1, idx, -torch.where(held, g, 0.0))
        return grad, None, None, None, None


def vocab_sharded_nll(logits, labels, cfg: ArchConfig, mesh):
    """Each row's (and codebook's) logz - gold, (B, S) or (B, S, K), from
    this rank's vocab columns of the logits (``lm_logits(gather=False)``,
    fp32) and the global labels (B, S[, K]; any in [0, V)), on a model
    axis above 1: a rank never holds the whole (rows, S, V). The
    logsumexp runs per codebook, whose columns may lie on one rank, span
    several, or share a rank with others."""
    books = labels if cfg.n_codebooks else labels[..., None]
    nll = _VocabShardedNLL.apply(logits, books, cfg.vocab_size,
                                 mesh.tp_rank * logits.shape[-1],
                                 mesh.model_group)
    return nll if cfg.n_codebooks else nll[..., 0]


def forward(params, tokens, cfg: ArchConfig, ctx: dict, states=None,
            gather: bool = True):
    """Returns (logits, aux, states). aux is the auxiliary loss summed over
    the layers (MoE's load-balancing loss), a 0-d fp32 tensor: zero for a
    model without MoE layers. ``gather``: ``lm_logits``'."""
    mesh = ctx.get("mesh")
    x = embed_tokens(params, tokens, cfg, ctx["compute_dtype"], mesh)
    x, aux, states = T.apply_stack(params, x, cfg, ctx, states)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params, x, cfg, mesh, gather), aux, states


def loss_fn(params, batch, cfg: ArchConfig, ctx: dict):
    """Next-token cross-entropy. batch: tokens (B, S) and labels (B, S),
    or (B, S, K) both with codebooks, labels[t] the target of position t,
    -100 (any negative) ignored; the VLM's batch also holds its vision
    states, which ``ctx`` carries (``make_ctx(vision=)``). Logits
    in fp32; the mean is over the valid labels (at least 1). Returns
    (loss + aux, {"loss", "aux_loss", "ntokens"}).

    On a mesh (``ctx["mesh"]``; batch: this rank's rows) the first value
    is this rank's share of the objective, whose gradients summed over
    the batch shards ("pod" x "data") are those of loss + aux: its NLL
    sum over the global count of valid labels, plus aux over the number of
    batch shards (aux is already the mean over them); over a batch the
    batch shards do not split, (loss + aux) over their number. The
    metrics are the global batch's. On a model axis above 1 the logits
    stay vocab-sharded (``vocab_sharded_nll``)."""
    mesh = ctx.get("mesh")
    sharded = mesh is not None and mesh.tp > 1
    logits, aux, _ = forward(params, batch["tokens"], cfg, ctx,
                             gather=not sharded)
    labels = batch["labels"]
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    if sharded:
        nll = vocab_sharded_nll(logits, safe, cfg, mesh) * valid
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, safe[..., None])[..., 0]
        nll = (logz - gold) * valid
    if mesh is not None and mesh.shards_batch:
        tot = S.all_reduce(torch.stack([nll.sum().detach().double(),
                                        valid.sum().double()]),
                           mesh.batch_group)
        ntok = tot[1].long().clamp_min(1)
        share = nll.sum() / ntok + aux / mesh.batches
        return share, {"loss": (tot[0] / ntok).float(), "aux_loss": aux,
                       "ntokens": ntok}
    ntok = valid.sum().clamp_min(1)
    loss = nll.sum() / ntok
    share = loss + aux if mesh is None else (loss + aux) / mesh.batches
    return share, {"loss": loss, "aux_loss": aux, "ntokens": ntok}


def prefill(params, tokens, cfg: ArchConfig, ctx: dict):
    """Forward over the prompt; returns last-position logits (B, V), or
    (B, K, V) with codebooks. The head
    runs on the last position only: each row's logits depend on that row
    alone, so the values are those of the reference's full-sequence head."""
    mesh = ctx.get("mesh")
    x = embed_tokens(params, tokens, cfg, ctx["compute_dtype"], mesh)
    x, _, _ = T.apply_stack(params, x, cfg, ctx)      # aux is not needed
    return lm_logits(params, x[:, -1:], cfg, mesh)[:, 0]


def decode_step(params, tokens, states, cache_len, cfg: ArchConfig,
                ctx: dict):
    """One-token decode. tokens (B, 1), or (B, 1, K) with codebooks; states
    from init_decode_state, updated in place. Returns (logits (B, 1, V) or
    (B, 1, K, V), states); the aux loss is dropped, as in the reference."""
    logits, _, states = forward(params, tokens, cfg, ctx, states)
    return logits, states
