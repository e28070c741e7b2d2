"""Train-step factory: loss, grads, clipping, AdamW, microbatch
accumulation, and the majority-vote compressed-DP variant.

The reference's two step flavors (:mod:`repro.train.train_step`) on
autograd:

* ``make_train_step`` — the plain step.  On plain tensors it runs on one
  device; on parameters that are DTensors (placed by
  :func:`repro_torch.distributed.sharding.tree_shardings`) and a batch
  sharded over the data axes, DTensor inserts the collectives the
  placements imply, as XLA does for the reference's ``jax.jit`` with
  ``in_shardings`` (:func:`repro_torch.launch.train.setup`).
* ``make_compressed_train_step`` — the per-process body over the data
  axes with *explicit* majority-vote sign compression of gradients (the
  paper's MAJ primitive lifted to distributed optimization): per-replica
  gradient signs are bit-packed 32×, all-gathered over the data group, and
  the element-wise majority vote — computed exactly like a SIMDRAM TRA, as
  a bit-plane popcount majority — becomes the update direction, with local
  error feedback.  Wire bytes drop 32× vs a float32 all-reduce.

The state's parameters are the model's own (a
:class:`~repro_torch.models.transformer.Transformer`), and a step updates
them, ``m``, ``v`` (and the error feedback) in place, only after the loss,
every backward pass and every collective of the step have succeeded: a
step that raises before its update leaves the state as it was, so a retry
from it is exact.  :func:`_pack_signs` and :func:`_majority_from_packed`
equal the reference's bit for bit, on int32 words that are its uint32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import batch_axes
from ..models.transformer import Transformer, check_cfg, leaf_names
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    """The model (updated in place by the step), its AdamW state and the
    compressed step's error-feedback residual (float32, keyed like ``m``;
    None for the plain step)."""
    params: Transformer
    opt: AdamWState
    error_fb: dict | None = None


def init_train_state(params: Transformer,
                     compressed: bool = False) -> TrainState:
    """A fresh state over ``params``: zeroed moments keyed by parameter
    name and, with ``compressed``, a zeroed float32 error feedback placed
    like each parameter (the reference's starts in the parameters' dtype
    and is float32 from the first step on)."""
    named = dict(params.named_parameters())
    err = ({k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in named.items()} if compressed else None)
    return TrainState(params=params, opt=adamw_init(named), error_fb=err)


def softmax_xent(logits, labels):
    logp = torch.log_softmax(logits.float(), -1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -ll.mean()


def _chunk_nll(h, labels, head):
    """−Σ log p(label) over one sequence chunk of hidden states."""
    logits = torch.einsum("bsd,dv->bsv", h, head.to(h.dtype))
    logp = torch.log_softmax(logits.float(), -1)
    return logp.gather(-1, labels[..., None].long()).sum()


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01,
                 loss_chunk: int = 0):
    """``loss_fn(model, batch) → (loss + aux_weight·aux, {"loss", "aux"})``.

    ``loss_chunk > 0`` enables the chunked-vocab loss: the LM head and
    cross-entropy run per sequence chunk (``s // max(1, s // loss_chunk)``
    positions, which must divide ``s``), each recomputed in the backward
    pass, so the (tokens × vocab) float32 logits tensor is never
    materialized — the memory-term optimization for large-vocab training
    cells."""
    def loss_fn(model: Transformer, batch: dict):
        check_cfg(model, cfg)
        if not loss_chunk:
            logits, aux, _ = model(batch)
            loss = softmax_xent(logits, batch["labels"])
            return loss + aux_weight * aux, {"loss": loss, "aux": aux}
        hidden, aux, _ = model(batch, return_hidden=True)
        head = model.embed.t() if cfg.tie_embeddings else model.lm_head
        b, s, d = hidden.shape
        n_chunks = max(1, s // loss_chunk)
        hs = hidden.reshape(b, n_chunks, s // n_chunks, d)
        ls = batch["labels"].reshape(b, n_chunks, s // n_chunks)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(n_chunks):
            if torch.is_grad_enabled():
                nll = checkpoint(_chunk_nll, hs[:, c], ls[:, c], head,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                nll = _chunk_nll(hs[:, c], ls[:, c], head)
            total = total - nll
        loss = total / (b * s)
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}
    return loss_fn


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` consecutive row blocks of every batch tensor (the reference's
    ``reshape(n, b // n, ...)``)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, loss_chunk: int = 0):
    """``train_step(state, batch) → (state, metrics)``: the gradients of
    ``loss + 0.01·aux`` (summed over ``microbatches`` row blocks, then
    divided by their number), clipped, and one AdamW update, in place.
    ``metrics`` holds ``loss`` and ``aux`` of the last microbatch (the
    reference's scan carry leaves them so), ``grad_norm`` and ``lr``, as
    0-d tensors; nothing in the step waits on the device.  A parameter
    without a gradient gets zeros, as ``jax.grad`` gives it."""
    loss_fn = make_loss_fn(cfg, loss_chunk=loss_chunk)

    def train_step(state: TrainState, batch: dict):
        named = dict(state.params.named_parameters())
        for p in named.values():
            p.grad = None
        parts = [batch] if microbatches == 1 else _microbatches(
            batch, microbatches)
        for part in parts:
            objective, metrics = loss_fn(state.params, part)
            objective.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        if microbatches > 1:
            torch._foreach_div_(list(grads.values()), microbatches)
        _, state.opt, stats = adamw_update(opt_cfg, state.opt, named, grads)
        metrics = {k: t.detach() for k, t in metrics.items()}
        metrics.update(stats)
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Majority-vote compressed data parallelism: the sign packing and the vote
# ---------------------------------------------------------------------------

_SHIFTS = torch.arange(32, dtype=torch.int32)


def _pack_signs(g: torch.Tensor) -> torch.Tensor:
    """float (..., n) → int32 (⌈n/32⌉,) packed sign bits (1 ⇔ g ≥ 0, so
    −0.0 packs as 1 and NaN as 0), bit i of word w for element 32·w + i;
    the words are the reference's uint32 bit for bit."""
    flat = g.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % 32))
    bits = (flat >= 0).to(torch.int64).reshape(-1, 32)
    words = (bits << _SHIFTS.to(g.device, torch.int64)).sum(-1)
    return words.to(torch.int32)        # wraps bit 31 to the sign bit


def _majority_from_packed(words: torch.Tensor, n_voters: int, n: int):
    """words: (R, W) int32 packed sign planes from R replicas → float32 ±1
    majority vote of the first ``n`` lanes (+1 iff more than half the
    voters packed a 1).

    This is SIMDRAM's TRA generalized to R inputs: a per-lane popcount
    against R/2 on the packed words."""
    shifts = _SHIFTS.to(words.device)
    unpacked = (words[:, :, None] >> shifts) & 1         # (R, W, 32)
    counts = unpacked.sum(0)                             # (W, 32)
    maj = (2 * counts > n_voters).float() * 2 - 1
    return maj.reshape(-1)[:n]


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective); ``t`` else."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _starts(leaves: list) -> list:
    """``(first parameter index, names)`` of each leaf."""
    out, i = [], 0
    for names in leaves:
        out.append((i, names))
        i += len(names)
    return out


def _like(local: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``local`` as this rank's block of a tensor placed like ``ref``."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               mesh, sign_lr_scale: float = 1.0,
                               fused: bool = True, two_phase: bool = False,
                               exchange: str = "packed"):
    """The per-process step: this rank's gradients → error-feedback add →
    packed sign exchange over the data axes → bit-plane majority vote →
    AdamW.  Returns ``(step, data_axes)``; ``step(state, batch)`` takes
    this rank's block of the batch (:func:`repro_torch.distributed.compat.
    shard_map_compat` gives it).

    Parameters sharded over ``model`` are DTensors on the mesh's ``model``
    dimension: the vote is element-wise and runs on each rank's local
    shard, while each leaf's scale ``mean|g + e|`` is the mean over the
    whole leaf (the reference's), then ``pmean``'d over the data group.

    ``fused=True`` (hillclimb H5): every leaf is flattened into one vector
    so the whole exchange is a single packed collective.  ``two_phase``
    (H7, fused only): the words are padded to a multiple of R, a 1/R slice
    goes to each voter by ``all_to_all``, each votes locally, repacks, and
    the slices are all-gathered — per-rank bytes ≈ 2·n/32 words whatever R.
    ``exchange``: ``"packed"`` (all-gather of bit-packed sign planes) or
    ``"psum"`` (an all-reduce of int32 ±1 votes — the identical majority,
    since popcount(ones) > R/2 ⇔ Σ±1 > 0, exchanged uncompressed).

    Metrics: ``loss`` is the data group's mean, ``grad_norm`` and ``lr``
    those of the voted gradient (the same on every rank), ``aux`` this
    rank's own (rank 0's is the one the reference returns).  The update
    (parameters, ``m``, ``v``, error feedback) happens in place after every
    collective of the step.  ``step.exchange`` is the vote alone, on given
    gradients (each parameter's, in the order of
    :func:`~repro_torch.models.transformer.leaf_names`).
    """
    from ..distributed.compat import ManualGroup
    if exchange not in ("packed", "psum"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    loss_fn = make_loss_fn(cfg, loss_chunk=cfg.loss_chunk)
    data_axes = batch_axes(mesh)
    group = ManualGroup(mesh, data_axes)
    n_voters = group.size
    # the reference's leaves: a stacked leaf is every layer's parameter
    leaves = leaf_names(cfg)
    keys = [k for names in leaves for k in names]
    width = max(len(names) for names in leaves)
    # each parameter's slot in a (leaves, width) table of per-leaf sums
    slots = torch.tensor([i * width + j for i, names in enumerate(leaves)
                          for j in range(len(names))])
    layout = {}

    def leaf_layout(gfs: list) -> dict:
        """What the placed gradients fix, computed at the first call: the
        slots on their device, each leaf's local and whole element counts,
        and the process groups whose shards a parameter's |g + e| sum is
        summed over (with the parameters sharded over each)."""
        if not layout:
            dev = _local(gfs[0]).device
            sizes = [sum(_local(g).numel() for g in gfs[i:i + len(names)])
                     for i, names in _starts(leaves)]
            numel = [sum(g.numel() for g in gfs[i:i + len(names)])
                     for i, names in _starts(leaves)]
            sharded = {}
            for j, g in enumerate(gfs):
                if isinstance(g, DTensor):
                    for d, p in enumerate(g.placements):
                        if p.is_shard():
                            sharded.setdefault(
                                g.device_mesh.get_group(d), []).append(j)
            layout.update(
                slots=slots.to(dev), sizes=sizes,
                numel=torch.tensor(numel, dtype=torch.float32, device=dev),
                shards=[(grp, torch.tensor(js, device=dev))
                        for grp, js in sharded.items()])
        return layout

    def vote(gf: torch.Tensor, mark) -> torch.Tensor:
        """±1 float32 majority of the flat local ``gf`` over the group."""
        n = gf.numel()
        if exchange == "psum":
            votes = torch.where(gf >= 0, 1, -1).to(torch.int32)
            mark("pack")
            summed = group.psum(votes)
            mark("all_reduce")
            maj = (summed > 0).float() * 2 - 1
            mark("vote")
            return maj
        packed = _pack_signs(gf)
        mark("pack")
        if not two_phase:
            gathered = group.all_gather(packed)
            mark("all_gather")
            maj = _majority_from_packed(gathered, n_voters, n)
            mark("vote")
            return maj
        pad = (-packed.shape[0]) % n_voters
        chunks = torch.nn.functional.pad(packed, (0, pad)).reshape(
            n_voters, -1)
        recv = group.all_to_all(chunks)         # row j: rank j's slice
        mark("all_to_all")
        repacked = _pack_signs(_majority_from_packed(recv, n_voters,
                                                     recv.shape[1] * 32))
        mark("vote")
        gathered = group.all_gather(repacked).reshape(1, -1)
        mark("all_gather")
        maj = _majority_from_packed(gathered, 1, n + pad * 32)[:n]
        mark("vote")
        return maj

    @torch.no_grad()
    def exchange(gfs: list, mark=lambda part: None) -> tuple:
        """The vote of one step: ``gfs`` are ``g + e`` (float32, placed
        like their parameters) of each parameter, in the reference's leaf
        order.  Returns this rank's flat decoded gradient and new error
        feedback of each parameter.  ``mark(part)`` is called as each part
        of the exchange ends (``"scales"``, ``"concat"``, ``"pack"``, the
        collectives by name, ``"vote"``, ``"decode"``), for timing."""
        c = leaf_layout(gfs)
        flats = [_local(g).reshape(-1) for g in gfs]
        # per leaf mean|g + e| over the whole leaf: each parameter's local
        # |·| sum, summed over the shards of a sharded one, then the leaf's
        sums = torch.stack(torch._foreach_norm(flats, 1))
        for grp, js in c["shards"]:
            part = sums[js]
            dist.all_reduce(part, group=grp)
            sums = sums.index_copy(0, js, part)
        table = sums.new_zeros(len(leaves) * width).index_copy(
            0, c["slots"], sums)
        means = table.reshape(len(leaves), width).sum(1) / c["numel"]
        mark("scales")
        flat = torch.cat(flats)
        mark("concat")
        if fused:
            scales = group.pmean(means)
            decoded = vote(flat, mark)
            for part, scale in zip(decoded.split(c["sizes"]), scales):
                part.mul_(scale)
        else:
            decoded = torch.cat([
                vote(f, mark) * group.pmean(m)
                for f, m in zip(flat.split(c["sizes"]), means)])
        err = flat.sub_(decoded)        # flat is the step's own copy
        mark("decode")
        per_param = [t.numel() for t in flats]
        return decoded.split(per_param), err.split(per_param)

    def step(state: TrainState, batch: dict):
        named = dict(state.params.named_parameters())
        for p in named.values():
            p.grad = None
        with implicit_replication():
            objective, metrics = loss_fn(state.params, batch)
            objective.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        with torch.no_grad():
            # a gradient placed otherwise than its parameter (a partial
            # sum over model) is reduced to the parameter's placements
            gfs = [grads[k].redistribute(named[k].device_mesh,
                                         named[k].placements).float()
                   if isinstance(grads[k], DTensor) else grads[k].float()
                   for k in keys]
            gfs = [g + state.error_fb[k] for g, k in zip(gfs, keys)]
            decoded, new_err = exchange(gfs)
            voted = {k: _like((d * sign_lr_scale).view_as(_local(g)), g)
                     for k, d, g in zip(keys, decoded, gfs)}
            loss = group.pmean(_plain(metrics["loss"].detach()).reshape(1))
        _, state.opt, stats = adamw_update(opt_cfg, state.opt, named, voted)
        with torch.no_grad():
            for k, e in zip(keys, new_err):
                _local(state.error_fb[k]).copy_(
                    e.reshape(_local(state.error_fb[k]).shape))
        out = {"loss": loss[0], "aux": _plain(metrics["aux"].detach())}
        out.update(stats)
        return state, {k: _plain(v) for k, v in out.items()}

    step.exchange = exchange
    return step, data_axes
