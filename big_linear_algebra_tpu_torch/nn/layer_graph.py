"""The legacy ``Layer``-graph MLP (≈ lib/layer.c), the counterpart of
``big_linear_algebra_tpu/nn/layer_graph.py``.

The reference builds a linked list of ``Layer`` structs and backprops
recursively with in-place SGD applied *after* the recursion, so upstream
gradients see pre-update weights (lib/layer.c:48-78: the recursive call at
:70 precedes the ``matrix_add`` updates at :72-73). Functionally that is
standard backprop-then-update on the whole stack, which ``sgd_step``
computes with the hand-written rule below (not autograd).

Math, per the reference derivation (lib/layer.c:80-106):
- forward: ``raw = W @ a_prev + b``; ``a = act(raw)`` (:6-20, keeping the
  pre-activation ``raw_nodes``)
- seed: ``dC/da_L = 2·(a_L − y)`` (:86-88) — squared-error loss
- per layer: ``δ = act'(raw) ⊙ dC/da``; ``ΔW = δ ⊗ a_prev``; ``Δb = δ``
  (:90-97); ``dC/da_prev = Wᵀ @ δ`` (:53-58)
- update: ``W −= lr·ΔW``, ``b −= lr·Δb`` (the reference folds −lr into δ)

Parameters are a list of ``(weights, biases)`` pairs with weights in the
reference's (out, in) orientation (so CSV layouts load without reshaping);
activation names are a tuple (one per layer), mirroring the reference's
function-pointer pairs (lib/layer.h:11-12).

``softmax_legacy`` implements the *intent* of model/mnist.c:27-46 — a true
softmax forward (the reference forgot the ``exp`` in the numerator,
SURVEY.md §7.7) with the deliberate diagonal-only Jacobian ``p·(1−p)``
backward (the independence approximation is written out intentionally in
softmax_ddx).

Where the JAX package runs many steps as one ``lax.scan`` dispatch,
``make_sgd_scan`` here replays a CUDA graph of ``unroll`` per-example
steps over static buffers (``utils/graphs.py``; one example is a few dozen
small kernels, which the host would otherwise launch one by one), eager
on the CPU and under the debug modes. The costs stay on the device and are
read once, after the loop. The forward's ``W @ a + b`` is one ``addmv`` and
the update ``W − lr·δ⊗a`` one ``addr``: the same values as the JAX
package's separate ops, rounded once fewer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]  # [(W (out,in), b (out,))]


class Activation(NamedTuple):
    fn: Callable[[torch.Tensor], torch.Tensor]
    # ddx receives (raw, activated) and returns act'(raw)
    ddx: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _softmax_fn(raw: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis (one example's outputs, or each row of a
    batch), max-subtracted."""
    e = torch.exp(raw - torch.amax(raw, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


ACTIVATIONS: Dict[str, Activation] = {
    "relu": Activation(lambda r: torch.clamp_min(r, 0),
                       lambda r, a: (r > 0).to(r.dtype)),
    "linear": Activation(lambda r: r, lambda r, a: torch.ones_like(r)),
    # main.c:7-17's toy 0.1x activation
    "scale_0.1": Activation(lambda r: 0.1 * r,
                            lambda r, a: torch.full_like(r, 0.1)),
    "softmax_legacy": Activation(_softmax_fn, lambda r, a: a * (1 - a)),
}


def params_from_jax(np_params) -> Params:
    """The JAX package's params (a list of (w, b) numpy pairs, same
    layouts) as the port's CPU tensors, dtype kept. Arrays from JAX are
    read-only, so each is copied before ``torch.from_numpy``."""
    return [(torch.from_numpy(np.array(w, copy=True)),
             torch.from_numpy(np.array(b, copy=True))) for w, b in np_params]


def feed_forward(params: Params, activations: Sequence[str],
                 x: torch.Tensor):
    """Forward a single example (in,) through the stack.
    Returns (acts, raws): acts[0] is x, acts[i+1] the i-th layer output."""
    acts, raws = [x], []
    a = x
    for (w, b), name in zip(params, activations):
        raw = torch.addmv(b, w, a)
        a = ACTIVATIONS[name].fn(raw)
        raws.append(raw)
        acts.append(a)
    return acts, raws


def predict(params: Params, activations: Sequence[str],
            x: torch.Tensor) -> torch.Tensor:
    return feed_forward(params, activations, x)[0][-1]


def predict_batch(params: Params, activations: Sequence[str],
                  xb: torch.Tensor) -> torch.Tensor:
    """Batched forward for evaluation: (B, in) → (B, out), each row as
    ``predict`` computes it (the JAX package vmaps ``predict``)."""
    a = xb
    for (w, b), name in zip(params, activations):
        a = ACTIVATIONS[name].fn(torch.addmm(b, a, w.T))
    return a


def cost(params: Params, activations: Sequence[str], x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """Squared-error cost Σ(y − a)² (model/my_first_model.c:102-105)."""
    out = predict(params, activations, x)
    return torch.sum((y - out) ** 2)


def _sgd_step_cost(params: Params, activations: Sequence[str],
                   x: torch.Tensor, y: torch.Tensor, lr: float):
    """One reference backprop + SGD update (lib/layer.c:80), returning
    (new_params, pre-update cost) from the SAME forward pass — the loop
    logs the cost the reference computes from the pass it then backprops
    (model/my_first_model.c:102-105), without a second forward."""
    acts, raws = feed_forward(params, activations, x)
    diff = acts[-1] - y
    c = torch.dot(diff, diff)
    dCda = 2.0 * diff
    new_params: Params = [None] * len(params)
    for i in reversed(range(len(params))):
        w, b = params[i]
        delta = ACTIVATIONS[activations[i]].ddx(raws[i], acts[i + 1]) * dCda
        if i:  # pre-update weights (lib/layer.c:70); the input needs none
            dCda = torch.mv(w.T, delta)
        new_params[i] = (torch.addr(w, delta, acts[i], alpha=-lr),
                         torch.add(b, delta, alpha=-lr))
    return new_params, c


@torch.no_grad()
def sgd_step(params: Params, activations: Sequence[str], x: torch.Tensor,
             y: torch.Tensor, lr: float) -> Params:
    """One reference backprop + SGD update (lib/layer.c:80)."""
    return _sgd_step_cost(params, activations, x, y, lr)[0]


def make_sgd_step(activations: Sequence[str]):
    """The step for a fixed activation stack:
    ``step(params, x, y, lr) -> new_params``."""
    acts = tuple(activations)

    def step(params, x, y, lr):
        return sgd_step(params, acts, x, y, lr)

    return step


class _ScanSteps:
    """The state of ``make_sgd_scan``'s steps: copies of the parameters,
    the examples, the costs (T,) and a device counter. A step reads example
    ``counter``, writes the updated parameters back into their buffers and
    its cost at ``counter``, and advances the counter; it holds no
    reference to the ``StepGraph`` that replays it."""

    def __init__(self, params: Params, activations: Tuple[str, ...],
                 xs: torch.Tensor, ys: torch.Tensor, lr: float):
        self.params = [(w.clone(), b.clone()) for w, b in params]
        self.acts, self.xs, self.ys, self.lr = activations, xs, ys, lr
        self.costs = torch.zeros(
            xs.shape[0], device=xs.device,
            dtype=torch.promote_types(params[-1][0].dtype, xs.dtype))
        self.counter = torch.zeros((), dtype=torch.int64, device=xs.device)

    def step(self) -> None:
        row = self.counter.reshape(1)
        new, c = _sgd_step_cost(self.params, self.acts,
                                self.xs.index_select(0, row)[0],
                                self.ys.index_select(0, row)[0], self.lr)
        for (w, b), (nw, nb) in zip(self.params, new):
            w.copy_(nw)
            b.copy_(nb)
        self.costs.index_copy_(0, row, c.reshape(1))
        self.counter.add_(1)


def make_sgd_scan(activations: Sequence[str], unroll: int = 2,
                  graphed=None):
    """Many per-example SGD steps:
    ``run(params, xs (T, in), ys (T, out), lr) -> (params, costs (T,))``.

    Identical to T sequential ``sgd_step`` calls (online SGD in example
    order); each cost is the pre-update squared error, as the reference
    logs it (model/my_first_model.c:102-105). The steps run over static
    buffers (``_ScanSteps``); on a card a graph of ``unroll`` steps is
    replayed (``StepGraph.run``: the first steps eager as the warm-up,
    then ⌊(T − those) / unroll⌋ replays), bit-equal to the eager steps;
    ``graphed`` as ``StepGraph``'s (default: ``graphs_allowed``). The costs
    stay on the parameters' device: the loop never waits for the device."""
    from big_linear_algebra_tpu_torch.utils import graphs

    acts = tuple(activations)

    @torch.no_grad()
    def run(params, xs, ys, lr):
        if xs.shape[0] == 0:
            return params, xs.new_zeros(0)
        steps = _ScanSteps(params, acts, xs, ys, lr)
        graphs.StepGraph(unroll, xs.device, graphed=graphed).run(
            xs.shape[0], steps.step)
        return steps.params, steps.costs

    return run
