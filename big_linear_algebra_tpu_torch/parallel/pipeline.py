"""Pipeline parallelism on ``torch.distributed``, the counterpart of
``big_linear_algebra_tpu/parallel/pipeline.py``.

Each rank of the ``stage`` axis is one stage and runs only its own stage
function, so the port needs neither JAX's ``lax.switch`` over the stages
nor its padded flat buffers (they exist so that every TPU device runs one
SPMD program). Microbatches enter at stage 0 and move one stage a tick
through ``spmd.hop`` (JAX's ``ppermute``, ``i → i+1``; cotangents go
``i+1 → i``). On a fill or drain tick a rank does not run its stage at all
(JAX's ``lax.cond``): a stage that is not total on zeros cannot poison the
gradients. Every rank still takes part in every tick's exchange, sending
zeros when it has nothing, so that the ranks post their operations in one
fixed order.

- ``gpipe``: uniform stages over a stacked parameter tree.
- ``gpipe_hetero``: stages of differing boundary and parameter shapes (the
  U-Net's down/mid/up). Each boundary travels at its own width and dtype:
  the receiver knows its shape from the plan (``hetero_stats``), which the
  stage chain run on fake tensors gives, as ``jax.eval_shape`` gives
  JAX's. Under autograd the backward is a ``torch.autograd.Function``
  whose backward replays the ticks in reverse, each microbatch's graph kept
  from the forward (GPipe: all forwards, then all backwards), sending each
  input cotangent to the previous stage.
- ``gpipe_hetero_1f1b``: the training pass on a one-forward-one-backward
  schedule; each backward unit recomputes its stage from the saved input
  boundary (a ring of 2S − 1 of them) and returns the loss and every
  stage's gradients.
- ``pipeline_plan``: the boundaries' shapes and dtypes, from the stage chain
  run on fake tensors. The schedules make it on each call unless the
  caller passes one it keeps (a train step keeps its own).
- ``data_axis`` (PP×DP): on a 2-D ``stage × data`` mesh each data
  coordinate runs its own ring over its ``n_micro / n_data`` microbatches.
- Training-mode stages draw from ``fold_generator(key, s·n_micro + m)``
  for stage s on global microbatch m (JAX's ``fold_in``), so a sequential
  run of the same chain reproduces every mask.

Parameters are replicated: every rank holds every stage's tree and uses
its own stage's subtree; ``assemble_grads`` makes each rank's stage
gradients the full gradient on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence

import torch

from big_linear_algebra_tpu_torch.parallel import spmd

_GOLDEN64 = 0x9E3779B97F4A7C15


def fold_seed(seed: int, index: int) -> int:
    """``seed`` with ``index`` folded in (JAX's ``fold_in(key, index)``):
    other indices give other seeds, the same one the same."""
    return (seed ^ ((index + 1) * _GOLDEN64)) & (2 ** 63 - 1)


def fold_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator of ``fold_seed(seed, index)``: other indices draw
    otherwise, the same one alike."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, index))


# ---------------------------------------------------------------------------
# Trees of tensors (tuples, lists, dicts) and the boundary plan
# ---------------------------------------------------------------------------


def _flatten(tree):
    """(leaves, rebuild): the tensors of a tree of tuples, lists and dicts
    in order, and the function that builds such a tree from a list."""
    if isinstance(tree, Mapping):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, at = {}, 0
            for k, (_, rb), n in zip(keys, parts, sizes):
                out[k] = rb(leaves[at:at + n])
                at += n
            return out
        return [l for p in parts for l in p[0]], rebuild
    if isinstance(tree, (tuple, list)):
        kind = type(tree)
        parts = [_flatten(x) for x in tree]
        sizes = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, at = [], 0
            for (_, rb), n in zip(parts, sizes):
                out.append(rb(leaves[at:at + n]))
                at += n
            return kind(out)
        return [l for p in parts for l in p[0]], rebuild
    return [tree], lambda leaves: leaves[0]


def _tree_map(fn, tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(x) for x in leaves])


def _promote(dtypes) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


@dataclasses.dataclass
class _Boundary:
    """One boundary's leaves (shapes, dtypes), the tree they build and the
    flat buffer it travels in: one tensor of the leaves' promoted dtype."""
    shapes: List[tuple]
    dtypes: List[torch.dtype]
    rebuild: Callable

    @property
    def numel(self) -> int:
        return sum(int(torch.Size(s).numel()) for s in self.shapes)

    @property
    def dtype(self) -> torch.dtype:
        return _promote(self.dtypes)

    def pack(self, tree) -> torch.Tensor:
        leaves, _ = _flatten(tree)
        return torch.cat([x.reshape(-1).to(self.dtype) for x in leaves])

    def unpack_leaves(self, flat: torch.Tensor) -> list:
        out, at = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            n = int(torch.Size(shape).numel())
            out.append(flat[at:at + n].reshape(shape).to(dtype))
            at += n
        return out

    def unpack(self, flat: torch.Tensor):
        return self.rebuild(self.unpack_leaves(flat))

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.numel, dtype=self.dtype, device=device)


def _boundary(tree) -> _Boundary:
    leaves, rebuild = _flatten(tree)
    return _Boundary([tuple(x.shape) for x in leaves],
                     [x.dtype for x in leaves], rebuild)


def _signature(stage_fns, stage_params, xs, key) -> tuple:
    return (tuple(stage_fns), key is None,
            tuple((tuple(x.shape), x.dtype) for p in (xs, *stage_params)
                  for x in _flatten(p)[0]))


@dataclasses.dataclass
class Plan:
    """A pipeline's boundaries: boundary 0 is one microbatch of ``xs``,
    boundary i+1 the output of stage i on boundary i. ``signature``: the
    stage functions, keyed or not, and the shapes and dtypes it was made
    for."""
    n_micro: int
    bounds: List[_Boundary]
    signature: tuple

    def fits(self, stage_fns, stage_params, xs, key=None) -> bool:
        return self.signature == _signature(stage_fns, stage_params, xs, key)


def pipeline_plan(stage_fns, stage_params, xs, key=None) -> Plan:
    """The ``Plan`` of a pipeline run, derived by running the stage chain on
    fake tensors: shapes and dtypes only, nothing is computed and no
    generator advances."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x_leaves, x_rebuild = _flatten(xs)
    n_micro = int(x_leaves[0].shape[0])
    gen = torch.Generator() if key is not None else None

    def fake(x):
        return torch.empty(x.shape, dtype=x.dtype)

    with FakeTensorMode(), torch.no_grad():
        b = x_rebuild([torch.empty(x.shape[1:], dtype=x.dtype)
                       for x in x_leaves])
        bounds = [_boundary(b)]
        for fn, p in zip(stage_fns, stage_params):
            args = (_tree_map(fake, p), b) + ((gen,) if key is not None
                                              else ())
            b = fn(*args)
            bounds.append(_boundary(b))
    return Plan(n_micro, bounds,
                _signature(stage_fns, stage_params, xs, key))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def hetero_stats(stage_fns: Sequence[Callable], stage_params: Sequence, xs,
                 key=None) -> dict:
    """JAX's ``hetero_stats``: its keys and, for the same stages, its
    values, from the same plan, without running the pipeline.

    JAX pads every boundary to the widest and every tick moves that width
    (``bytes_per_tick``, ``ppermute_bytes_total``, ``ring_bytes_total``).
    The port moves each boundary at its own width and dtype, so the bytes
    it really moves per microbatch are those of the internal boundaries at
    their own dtypes (``useful_boundary_bytes`` when every boundary has the
    widest dtype), forward and again backward, plus the zeros of fill and
    drain ticks; ``spmd.collective_bytes["hop"]`` counts them."""
    plan = pipeline_plan(stage_fns, stage_params, xs, key)
    n_micro, bounds = plan.n_micro, plan.bounds
    n_stages = len(stage_fns)
    n_ticks = n_micro + n_stages - 1
    widths = [b.numel for b in bounds]
    width = max(widths)
    dtype = _promote([b.dtype for b in bounds])
    itemsize = torch.empty((), dtype=dtype).element_size()
    p_leaves = [_flatten(p)[0] for p in stage_params]
    p_widths = [sum(x.numel() for x in leaves) for leaves in p_leaves]
    p_dtype = _promote([x.dtype for leaves in p_leaves for x in leaves])
    return {
        "n_stages": n_stages,
        "n_micro": n_micro,
        "n_ticks": n_ticks,
        "boundary_widths": widths,
        "padded_width": width,
        "boundary_dtype": _dtype_name(dtype),
        "padding_frac": [1.0 - w / width for w in widths],
        "bytes_per_tick": width * itemsize,
        "ppermute_bytes_total": n_ticks * width * itemsize,
        "ring_bytes_total": n_stages * n_ticks * width * itemsize,
        "useful_boundary_bytes": sum(widths[1:-1]) * n_micro * itemsize,
        "fill_drain_ticks": n_stages - 1,
        "utilization": n_micro / n_ticks,
        "n_slots_1f1b": n_micro + 2 * (n_stages - 1),
        "utilization_1f1b": n_micro / (n_micro + 2 * (n_stages - 1)),
        "param_widths": p_widths,
        "param_padded_width": max(p_widths),
        "param_dtype": _dtype_name(p_dtype),
    }


# ---------------------------------------------------------------------------
# One rank's stage and its schedules
# ---------------------------------------------------------------------------


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _or_zeros(g, x):
    return torch.zeros_like(x) if g is None else g


class _Stage:
    """This rank's part of a pipeline run: its stage function and
    parameters, its boundaries, its data coordinate's microbatches, and the
    hops to its neighbours. ``xs`` is the global stack (every rank holds
    it; stage 0 reads its data coordinate's share). ``plan``: the run's
    ``Plan`` (made here when None; one made for other shapes raises)."""

    def __init__(self, stage_fns, stage_params, xs, mesh, axis, key,
                 data_axis, plan):
        n_stages = len(stage_fns)
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} param trees for "
                             f"{n_stages} stage fns")
        if mesh.size(axis) != n_stages:
            raise ValueError(f"mesh axis {axis!r} has size "
                             f"{mesh.size(axis)}, need {n_stages} (one "
                             f"device per stage)")
        if plan is None:
            plan = pipeline_plan(stage_fns, stage_params, xs, key)
        elif not plan.fits(stage_fns, stage_params, xs, key):
            raise ValueError("the plan was made for other stage functions "
                             "or shapes")
        self.n_micro, self.bounds = plan.n_micro, plan.bounds
        n_data = 1 if data_axis is None else mesh.size(data_axis)
        if self.n_micro % n_data:
            raise ValueError(
                f"{self.n_micro} microbatches not divisible by data axis "
                f"{data_axis!r} of size {n_data}")
        self.S, self.M = n_stages, self.n_micro // n_data
        self.s = mesh.index(axis)
        self.base = 0 if data_axis is None else \
            mesh.index(data_axis) * self.M
        self.mesh, self.axis, self.data_axis = mesh, axis, data_axis
        self.key = key
        self.fn = stage_fns[self.s]
        self.b_in, self.b_out = self.bounds[self.s], self.bounds[self.s + 1]
        x_leaves, self.x_rebuild = _flatten(xs)
        self.x_leaves = [x[self.base:self.base + self.M] for x in x_leaves]
        self.device = x_leaves[0].device
        self.in_like = [self.b_in.zeros(self.device)]
        self.out_like = [self.b_out.zeros(self.device)]

    def input(self, m: int, recv):
        """Local microbatch m's input tree: from ``xs`` at stage 0, else
        the received buffer."""
        if self.s == 0:
            return self.x_rebuild([x[m] for x in self.x_leaves])
        return self.b_in.unpack(recv[0])

    def run(self, params, x, m: int):
        """The stage on input tree x for local microbatch m; in training
        mode with the generator of (key, s·n_micro + global m)."""
        if self.key is None:
            return self.fn(params, x)
        index = self.s * self.n_micro + self.base + m
        return self.fn(params, x, fold_generator(self.key, index,
                                                 self.device))

    def forward_hop(self, flat: Optional[torch.Tensor]):
        """Send this stage's output buffer on (zeros when it has none);
        receive its next input buffer (None at stage 0)."""
        send = None if self.s == self.S - 1 else [
            self.out_like[0] if flat is None else flat]
        return spmd.hop(send, self.mesh, self.axis, 1, wrap=False,
                        like=self.in_like)

    def backward_hop(self, flat: Optional[torch.Tensor]):
        """Send the input cotangent back (zeros when there is none);
        receive the cotangent of the output to back up next (None at the
        last stage)."""
        send = None if self.s == 0 else [
            self.in_like[0] if flat is None else flat]
        return spmd.hop(send, self.mesh, self.axis, -1, wrap=False,
                        like=self.out_like)

    def graph(self, params, x, m: int):
        """(input leaves, output leaves) of the stage on x for microbatch
        m, its autograd graph kept. Floating inputs past stage 0 are
        leaves that take gradients."""
        x_leaves, x_rebuild = _flatten(x)
        x_rg = [t.detach().requires_grad_(self.s > 0
                                           and t.is_floating_point())
                for t in x_leaves]
        with torch.enable_grad():
            out = self.run(params, x_rebuild(x_rg), m)
        return x_rg, _flatten(out)[0]

    def vjp(self, p_rg, x_rg, out_leaves, g_leaves):
        """(input cotangent buffer, None at stage 0; parameter gradients)
        of one microbatch's graph for output cotangents ``g_leaves``."""
        pairs = [(o, g.to(o.dtype)) for o, g in zip(out_leaves, g_leaves)
                 if o.requires_grad]
        wrt = p_rg + [x for x in x_rg if x.requires_grad]
        grads = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                     [g for _, g in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(wrt))
        dp = [_or_zeros(g, p) for g, p in zip(grads, p_rg)]
        if self.s == 0:
            return None, dp
        it = iter(grads[len(p_rg):])
        dx = [_or_zeros(next(it), x) if x.requires_grad
              else torch.zeros_like(x) for x in x_rg]
        return self.b_in.pack(dx), dp

    def _stacked(self, outs) -> list:
        """The last stage's outputs stacked per leaf, (M, ...); zeros of
        those shapes on the other stages."""
        last = self.bounds[-1]
        if self.s == self.S - 1:
            return [torch.stack(leaf) for leaf in zip(*outs)]
        return [torch.zeros((self.M,) + shape, dtype=dtype,
                            device=self.device)
                for shape, dtype in zip(last.shapes, last.dtypes)]

    def gpipe_forward(self, p_leaves, p_rebuild, keep: bool):
        """The GPipe ticks forward: (stacked outputs, graphs by microbatch
        when ``keep``)."""
        params = p_rebuild(p_leaves)
        n_ticks = self.M + self.S - 1
        outs, graphs, recv = [], {}, None
        for t in range(n_ticks):
            m = t - self.s
            flat = None
            if 0 <= m < self.M:  # not a fill or drain tick
                x = self.input(m, recv)
                if keep:
                    graphs[m] = self.graph(params, x, m)
                    out_leaves = graphs[m][1]
                else:
                    out_leaves = _flatten(self.run(params, x, m))[0]
                if self.s == self.S - 1:
                    outs.append([o.detach() for o in out_leaves])
                else:
                    flat = self.b_out.pack(out_leaves).detach()
            if t < n_ticks - 1 and self.S > 1:
                recv = self.forward_hop(flat)
        return self._stacked(outs), graphs

    def gpipe_backward(self, p_rg, graphs, g_outs) -> list:
        """The ticks replayed in reverse: each microbatch's graph backed up
        with the cotangent from the next stage (the loss's at the last),
        its input cotangent sent to the previous stage. Returns the
        parameter gradients summed over the microbatches."""
        acc = [torch.zeros(p.shape, dtype=_acc_dtype(p.dtype),
                           device=p.device) for p in p_rg]
        n_ticks = self.M + self.S - 1
        recv = None
        for t in reversed(range(n_ticks)):
            m = t - self.s
            flat = None
            if 0 <= m < self.M:
                g = ([g[m] for g in g_outs] if self.s == self.S - 1
                     else self.b_out.unpack_leaves(recv[0]))
                flat, dp = self.vjp(p_rg, *graphs.pop(m), g)
                acc = [a + d for a, d in zip(acc, dp)]
            if t > 0 and self.S > 1:
                recv = self.backward_hop(flat)
        return [a.to(p.dtype) for a, p in zip(acc, p_rg)]

    def one_f_one_b(self, p_leaves, p_rebuild, targets, seed_fn):
        """The 1F1B slots: (loss over this data coordinate's microbatches
        at the last stage, 0 elsewhere; this stage's parameter
        gradients)."""
        S, M, s = self.S, self.M, self.s
        n_slots, ring = M + 2 * (S - 1), 2 * S - 1
        saved = [None] * ring
        params = p_rebuild(p_leaves)
        t_leaves, t_rebuild = _flatten(targets)
        t_leaves = [x[self.base:self.base + M] for x in t_leaves]
        loss_dtype = _acc_dtype(_promote([b.dtype for b in self.bounds]))
        loss = torch.zeros((), dtype=loss_dtype, device=self.device)
        acc = [torch.zeros(p.shape, dtype=_acc_dtype(p.dtype),
                           device=p.device) for p in p_leaves]
        recv_f = recv_b = None
        for t in range(n_slots):
            # forward unit: microbatch t − s, no graph kept
            m_f, out_flat, seed = t - s, None, None
            if 0 <= m_f < M:
                x = self.input(m_f, recv_f)
                saved[t % ring] = x
                with torch.no_grad():
                    out = self.run(params, x, m_f)
                if s == S - 1:  # the loss seed, at the forward's slot
                    l_m, g_m = seed_fn(out, t_rebuild(
                        [x[m_f] for x in t_leaves]))
                    loss = loss + l_m.to(loss_dtype)
                    seed = _flatten(g_m)[0]
                else:
                    out_flat = self.b_out.pack(out)
            # backward unit: microbatch t − 2(S−1) + s, recomputed from its
            # saved input (forwarded at slot m_b + s) with its generator
            m_b, dx = t - 2 * (S - 1) + s, None
            if 0 <= m_b < M:
                g = (seed if s == S - 1
                     else self.b_out.unpack_leaves(recv_b[0]))
                p_rg = [p.detach().requires_grad_() for p in p_leaves]
                graph = self.graph(p_rebuild(p_rg),
                                   saved[(m_b + s) % ring], m_b)
                dx, dp = self.vjp(p_rg, *graph, g)
                acc = [a + d for a, d in zip(acc, dp)]
            if t < n_slots - 1 and S > 1:
                recv_f = self.forward_hop(out_flat)
                recv_b = self.backward_hop(dx)
        return loss, [a.to(p.dtype) for a, p in zip(acc, p_leaves)]


class _GPipe(torch.autograd.Function):
    """One rank's GPipe run as one autograd node: the forward runs every
    tick keeping each microbatch's graph, the backward replays the ticks in
    reverse (``_Stage.gpipe_backward``)."""

    @staticmethod
    def forward(ctx, stage, p_rebuild, *p_leaves):
        ctx.stage = stage
        ctx.p_rg = [p.detach().requires_grad_() for p in p_leaves]
        outs, ctx.graphs = stage.gpipe_forward(ctx.p_rg, p_rebuild, True)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        grads = ctx.stage.gpipe_backward(ctx.p_rg, ctx.graphs, g_outs)
        ctx.graphs = ctx.p_rg = None
        return (None, None, *grads)


def gpipe_hetero(stage_fns: Sequence[Callable], stage_params: Sequence, xs,
                 mesh, axis: str = "stage", key: Optional[int] = None,
                 data_axis: Optional[str] = None,
                 plan: Optional[Plan] = None):
    """GPipe over stages of differing boundary and parameter shapes.

    - ``stage_fns[i]``: ``(params_i, boundary_i) -> boundary_{i+1}``, any
      tree of tensors in and out; with ``key`` (an int seed) the signature
      is ``(params_i, boundary_i, generator)``, the generator
      ``fold_generator(key, i·n_micro + m)`` on microbatch m.
    - ``stage_params[i]``: stage i's parameter tree. Every rank holds all
      of them (their shapes make the plan); rank i runs stage i with its
      own tree, and under autograd only that tree gets gradients
      (``assemble_grads`` makes the full gradient).
    - ``xs``: a tree whose leaves carry a leading ``n_micro`` dim, the
      same on every rank.

    Bytes that travel: each microbatch's boundary i at its own width and
    dtype from rank i−1 to rank i once forward (and its cotangent once
    backward under autograd), plus zeros of the boundary's width on each
    rank's fill and drain ticks; nothing is padded to the widest boundary.

    Returns the stacked final boundary, (n_micro, ...) per leaf, on every
    rank of the stage line (summed over ``axis`` from the last stage, whose
    backward is the identity). With ``data_axis`` each data coordinate runs
    its own ring over its ``n_micro / n_data`` microbatches and gets their
    outputs (JAX's data-sharded result, one shard per coordinate); the
    dropout folds use global microbatch indices. ``plan``: the run's
    ``pipeline_plan``, made here when None."""
    st = _Stage(stage_fns, stage_params, xs, mesh, axis, key, data_axis,
                plan)
    p_leaves, p_rebuild = _flatten(stage_params[st.s])
    if torch.is_grad_enabled() and any(p.requires_grad for p in p_leaves):
        outs = _GPipe.apply(st, p_rebuild, *p_leaves)
    else:
        outs = st.gpipe_forward(p_leaves, p_rebuild, False)[0]
    return st.bounds[-1].rebuild([spmd.psum(o, mesh, axis) for o in outs])


def gpipe_hetero_1f1b(stage_fns: Sequence[Callable], stage_params: Sequence,
                      xs, targets, seed_fn: Callable, mesh,
                      axis: str = "stage", key: Optional[int] = None,
                      data_axis: Optional[str] = None,
                      plan: Optional[Plan] = None):
    """The heterogeneous pipeline's training pass on a 1F1B schedule.

    Each slot every stage runs one forward unit (no graph kept; its input
    saved in a ring of 2S − 1 slots) and one backward unit, which
    recomputes the stage from the saved input with the same generator and
    calls ``torch.autograd.grad``. Microbatch m's forward at stage s runs at
    slot s + m, its backward at slot m + 2(S−1) − s, so the last stage
    backs up each microbatch in the slot it forwards it: ``n_micro +
    2(S−1)`` slots. ``seed_fn(pred, target) -> (loss, dL/dpred)`` is the
    analytic loss seed at the last stage; ``targets`` a tree with a leading
    ``n_micro`` dim, like ``xs``. ``data_axis``: each data coordinate runs
    its own ring, and ``plan`` is the run's, as in ``gpipe_hetero``.

    Returns ``(loss_sum, stage_grads)``: the summed per-microbatch losses
    and every stage's gradient tree, the same on every rank (summed over
    ``data_axis``, then assembled over ``axis``)."""
    st = _Stage(stage_fns, stage_params, xs, mesh, axis, key, data_axis,
                plan)
    p_leaves, p_rebuild = _flatten(stage_params[st.s])
    loss, grads = st.one_f_one_b(p_leaves, p_rebuild, targets, seed_fn)
    loss = spmd.psum(loss, mesh, axis)
    if data_axis is not None:
        loss = spmd.psum(loss, mesh, data_axis)
    return loss, assemble_grads(p_rebuild(grads), stage_params, mesh, axis,
                                data_axis)


def assemble_grads(grads, stage_params: Sequence, mesh, axis: str,
                   data_axis: Optional[str] = None) -> list:
    """Every stage's gradient tree, the same on every rank, from this
    rank's stage gradients ``grads`` (None where a leaf got none): summed
    over ``data_axis`` (each data coordinate's share), then zero-padded to
    the list of every stage's tree and summed over ``axis``. Sums with
    zeros are exact, so the replicas receive the same bits."""
    s = mesh.index(axis)
    own, rebuild = _flatten(grads)
    mine, _ = _flatten(stage_params[s])
    own = [_or_zeros(g, p) for g, p in zip(own, mine)]
    if data_axis is not None:
        own = _psum_leaves(own, mesh, data_axis)
    full = [rebuild(own) if i == s else _tree_map(torch.zeros_like, p)
            for i, p in enumerate(stage_params)]
    leaves, rebuild_all = _flatten(full)
    return rebuild_all(_psum_leaves(leaves, mesh, axis))


def _psum_leaves(leaves: list, mesh, axis: str) -> list:
    summed = spmd.psum_tree({str(i): x for i, x in enumerate(leaves)},
                            mesh, axis)
    return [summed[str(i)] for i in range(len(leaves))]


class _StageRow(torch.autograd.Function):
    """This rank's row of a replicated stacked leaf; backward: the
    cotangent in that row of zeros, summed over the axis, so that every
    rank holds the whole stacked gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.shape = mesh, axis, x.shape
        ctx.row = mesh.index(axis)
        return x[ctx.row].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.row] = g
        return spmd.psum(full, ctx.mesh, ctx.axis), None, None


def gpipe(stage_fn: Callable, stacked_params, xs, mesh, axis: str = "stage"):
    """``stage_fn`` S times in pipeline over the ``axis`` ranks (S =
    ``mesh.size(axis)``): ``stacked_params`` leaves carry a leading stage
    dim of size S (rank i runs row i; every rank holds the stack, and under
    autograd every rank gets its whole gradient); ``xs``: (n_micro, ...),
    every microbatch through all S stages in order. Returns the same
    shape, on every rank."""
    n_stages = mesh.size(axis)
    leaves, rebuild = _flatten(stacked_params)
    for leaf in leaves:
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked_params leading dim {leaf.shape[0]} != stage axis "
                f"size {n_stages}")
    s = mesh.index(axis)
    rows = [rebuild([_StageRow.apply(x, mesh, axis) if i == s else x[i]
                     for x in leaves]) for i in range(n_stages)]
    return gpipe_hetero([stage_fn] * n_stages, rows, xs, mesh, axis)
