"""Train step: grad + clip + AdamW, with microbatch accumulation, remat and
bit-flip metrics — the single-device step of ``repro.train.trainer``,
ported to PyTorch:

    make_train_step(spec, ...)(master, opt_state, batch)
        -> (master, opt_state, metrics)

and the plain step of the CNN examples, ``make_classifier_step``.

The step takes gradients with respect to the compute-dtype copy of the
fp32 master (the identity at fp32), casts them to fp32, and lets AdamW
write the new master and moments into the given tensors (``optim/adamw``:
the returned trees are the ones passed in).

Metrics: ``loss`` / ``ce`` / ``aux`` / ``n_tokens`` (summed, not averaged,
across microbatches) / ``grad_norm`` / ``lr``, and with
``bit_flip_metrics_on`` the 1809.10463 training-health signal — the
per-layer fraction of binarized weights whose master sign changed this step
(``bit_flip/<layer>``) and the weighted overall ``bit_flip_rate``.  Values
are 0-d tensors on the params' device.

Left for later slices: the sharded DP step, ``TrainLayouts``,
``TrainState`` and its 1-bit error-feedback residual ``ef`` (ROADMAP A14),
and ``PolicyScheduledStep`` (A15).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import lm as lm_model
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.train import losses
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any

# aux metric keys accumulated by SUM (not mean) across microbatches —
# counters, not averages
SUM_AUX_KEYS = ("n_tokens",)


def _cast_floating(tree, dtype):
    def c(x):
        return x.to(dtype) if x.is_floating_point() else x
    return tree_map(c, tree)


def loss_fn_for(spec: ArchSpec) -> Callable:
    if spec.family == "lm":
        return functools.partial(losses.lm_loss, lm_model.forward)
    if spec.family == "whisper":
        raise NotImplementedError(
            "whisper training: the whisper family is not in the port yet "
            "(ROADMAP A13)")
    raise ValueError(spec.family)


def _split_micro(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n chunks of (B/n, ...), in order."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of microbatch {n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def _reduce_aux(aux: dict, reduce_mean, reduce_sum) -> dict:
    return {
        k: (reduce_sum(v) if k in SUM_AUX_KEYS else reduce_mean(v))
        for k, v in aux.items()
    }


def _value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over the floating
    leaves of a param tree: ``grad_fn(params, batch) -> ((loss, aux),
    grads)``, grads shaped and typed as ``params`` (zeros for a leaf the
    loss does not reach, integer leaves passed through).  The returned
    values are detached."""

    def grad_fn(params, batch):
        flat: list[torch.Tensor] = []

        def track(x):
            if not x.is_floating_point():
                return x
            x = x.detach().requires_grad_(True)
            flat.append(x)
            return x

        with torch.enable_grad():
            tracked = tree_map(track, params)
            loss, aux = loss_fn(tracked, batch)
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))

        def grad_of(x):
            if not x.is_floating_point():
                return x
            g = next(gs)
            return torch.zeros_like(x) if g is None else g

        grads = tree_map(grad_of, params)
        aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}
        return (loss.detach(), aux), grads

    return grad_fn


def _accumulate_grads(grad_fn, params, batch, microbatch):
    """(loss, aux, fp32 grads), averaged over ``microbatch`` sequential
    chunks: a left fold from fp32 zeros, then ``/ microbatch``
    (``SUM_AUX_KEYS`` aux entries summed instead of averaged)."""
    if not microbatch or microbatch <= 1:
        (loss, aux), grads = grad_fn(params, batch)
        return loss, aux, _cast_floating(grads, torch.float32)

    g_acc = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    l_acc = 0.0
    auxes = []
    for mb in _split_micro(batch, microbatch):
        (l, aux), g = grad_fn(params, mb)

        def add(a, b):
            a += b.to(torch.float32)
        tree_map(add, g_acc, g)
        del g
        l_acc = l_acc + l
        auxes.append(aux)
    grads = tree_map(lambda g: g.div_(microbatch), g_acc)
    stacked = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
    aux = _reduce_aux(stacked, lambda v: v.mean(0), lambda v: v.sum(0))
    return l_acc / microbatch, aux, grads


# ---------------------------------------------------------------------------
# bit-flip-rate metrics (Bethge et al. 1809.10463 §5: the fraction of
# binarized weights whose sign changed this step — high early, decaying as
# training settles; flat zero = dead, non-decaying = thrashing)
# ---------------------------------------------------------------------------


def binary_weight_paths(params: Pytree, policy: QuantPolicy) -> list[str]:
    """Paths of weight leaves the policy binarizes (w_bits == 1): a GEMM
    weight leaf ``.../<layer>/w`` is binarized iff
    ``policy.spec(".../<layer>")`` says so."""
    out: list[str] = []

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/{i}" if path else str(i))
        elif (path.endswith("/w") and getattr(node, "ndim", 0) >= 2
              and policy.spec(path[:-2]).w_bits == 1):
            out.append(path)

    rec(params, "")
    return out


def _get_by_path(tree: Pytree, path: str):
    node = tree
    for seg in path.split("/"):
        node = node[int(seg)] if isinstance(node, (list, tuple)) else node[seg]
    return node


def _signs(params: Pytree, paths: list[str]) -> dict[str, torch.Tensor]:
    # sign convention of core.quant.sign_ste: x >= 0 -> +1
    return {p: _get_by_path(params, p) >= 0 for p in paths}


def _flip_rates(old: dict, new: dict) -> dict:
    """Rates from two :func:`_signs` snapshots.  Flips are counted exactly
    (int64) and divided in float64, then rounded once to float32: the JAX
    function's value wherever its float32 counts are exact (below 2^24)."""
    out = {}
    flips_total = 0
    n_total = 0
    for p, a in old.items():
        flips = (a != new[p]).sum()
        out[f"bit_flip/{p[:-2]}"] = (flips.to(torch.float64)
                                     / a.numel()).to(torch.float32)
        flips_total = flips_total + flips
        n_total += a.numel()
    out["bit_flip_rate"] = (flips_total.to(torch.float64)
                            / n_total).to(torch.float32)
    return out


def bit_flip_metrics(
    policy: QuantPolicy, old_params: Pytree, new_params: Pytree
) -> dict:
    """Per-layer + overall sign-flip rates of the binarized master weights
    between two steps.  ``{}`` when the policy binarizes nothing."""
    paths = binary_weight_paths(old_params, policy)
    if not paths:
        return {}
    return _flip_rates(_signs(old_params, paths), _signs(new_params, paths))


# ---------------------------------------------------------------------------
# single-device step
# ---------------------------------------------------------------------------


def make_train_step(
    spec: ArchSpec,
    cfg: Any,
    ctx: QCtx,
    opt_cfg: adamw.AdamWConfig,
    *,
    remat: bool = True,
    microbatch: int | None = None,
    bit_flip_metrics_on: bool = False,
):
    """Step over (fp32 master params, opt state, batch).  ``batch`` holds
    ``tokens`` / ``targets`` (numpy or tensors); it is moved to the
    master's device.  The master and opt state are updated in place and
    returned."""
    loss_fn = loss_fn_for(spec)

    def compute_loss(params, batch):
        return loss_fn(params, cfg, ctx, batch, remat=remat)

    grad_fn = _value_and_grad(compute_loss)

    def train_step(master, opt_state, batch):
        dev = tree_leaves(master)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = _cast_floating(master, ctx.compute_dtype)
        loss, aux, grads = _accumulate_grads(grad_fn, params, batch,
                                             microbatch)
        del params
        paths = (binary_weight_paths(master, ctx.policy)
                 if bit_flip_metrics_on else [])
        old = _signs(master, paths)
        master, opt_state, opt_metrics = adamw.update(
            grads, opt_state, master, opt_cfg
        )
        metrics = {"loss": loss, **opt_metrics, **aux}
        if paths:
            metrics.update(_flip_rates(old, _signs(master, paths)))
        return master, opt_state, metrics

    return train_step


def make_classifier_step(forward: Callable, cfg: Any, ctx: QCtx,
                         opt_cfg: adamw.AdamWConfig):
    """The CNN examples' step: ``step(params, opt_state, x, y) -> (params,
    opt_state, loss)``, one AdamW step on ``losses.classifier_loss`` of
    ``forward(params, cfg, ctx, x)``; params and state updated in place."""
    def loss_fn(p, batch):
        return losses.classifier_loss(forward(p, cfg, ctx, batch["x"]),
                                      batch["y"]), {}

    grad_fn = _value_and_grad(loss_fn)

    def step(params, opt_state, x, y):
        (loss, _), grads = grad_fn(params, {"x": x, "y": y})
        params, opt_state, _ = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss

    return step


def init_all(spec: ArchSpec, cfg: Any, gen: torch.Generator):
    """(params, opt_state) init on ``gen``'s device."""
    if spec.family == "lm":
        params = lm_model.init(gen, cfg)
    else:
        raise ValueError(f"family {spec.family!r} is not in the port yet")
    return params, adamw.init(params)
