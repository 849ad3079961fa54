"""Serving launcher: initialise a model from a seed, convert it to packed
words, and serve requests through the continuous-batching scheduler on the
hand-written kernels (PyTorch port of ``repro.launch.serve``'s packed lm
path).

Params come from the port's own seeded init (a ``torch.Generator`` on the
device), then ``core/converter.convert`` under the ``--quant`` policy:
``binary`` (1-bit sign words, the default) or DoReFa ``wXaY`` such as
``w4a4`` / ``w8a8`` (bit-plane stacks; ``--backend vpu`` resolves onto the
``vpu-kX`` plane kernels and ``mxu`` onto ``mxu-kX`` per layer).  Compute
dtype is float32.  ``--check-fakequant`` also serves the float (fake-quant)
model: at 1 bit it asserts identical greedy tokens (paper §2.2.2); at k
bits, where packed and fake-quant agree per GEMM to fp32 rounding only, it
reports how many tokens agree and where the streams first part.

``--arch`` resolves through the registry: granite-3-2b, or the MoE
deepseek-moe-16b / qwen2-moe-a2.7b, whose packed experts run on the
expert-batched kernels (1-bit sign words on K7 / K8, DoReFa plane stacks
on K9 / K10 with ``--quant wXaY``).  The model is initialised whole in
fp32 before packing, so cut full-width deepseek-moe with ``--layers``.

``--packed PATH`` serves a packed checkpoint instead of a seeded model:
the ``.npz`` that ``python -m repro_torch.launch.train --export-packed`` (or
the JAX package's ``export_packed``) wrote, read by :func:`load_packed` into
the converter's tree for ``--arch`` / ``--quant`` without building the fp32
model.

``--kv-block-size N`` swaps the per-slot contiguous KV slabs for the
block-table paged pool (greedy tokens stay bit-identical); add
``--prefill-chunk`` to interleave long-prompt prefill with decode steps and
``--shared-prefix`` to refcount-share already-prefilled prompt-prefix blocks
across requests (every prompt then opens with a common ``--prompt-len``
token "system prompt", and the stats line reports the prefill tokens saved).
``--fused-attn`` routes decode / window attention through the hand-written
flash-decode kernel (``csrc/flash_decode.cu``), which reads the KV storage in
place through the block tables instead of gathering it every step, and
``--kv-bits {8,1}`` stores the KV cache itself quantized (int8 absmax /
1-bit sign + alpha).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --backend vpu --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --quant w4a4 --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --prompts 2 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --packed /tmp/g.packed.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --smoke --device cpu --backend mxu --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --smoke --device cpu --quant w4a4 --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --quant binary --backend vpu --kv-block-size 16 --prefill-chunk 256 \\
      --shared-prefix --fused-attn --kv-bits 8
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.ckpt.manager import _unflatten_into
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.models import lm as lm_model
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.interop import params_from_numpy
from repro_torch.serve.engine import Engine, EngineConfig, Request, Scheduler
from repro_torch.tree import tree_map


def parse_quant(s: str) -> QuantPolicy:
    """``fp`` | ``binary`` | ``binary_scaled`` | ``wXaY`` (e.g. ``w4a4``)."""
    if s == "fp":
        return QuantPolicy.full_precision()
    if s == "binary":
        return QuantPolicy.binary()
    if s == "binary_scaled":
        return QuantPolicy.binary(scale=True)
    if s.startswith("w") and "a" in s:  # e.g. w2a4
        w, a = s[1:].split("a")
        return QuantPolicy.quantized(int(w), int(a))
    raise ValueError(f"bad quant {s!r}")


def packed_template(cfg, policy: QuantPolicy):
    """The converter's output tree for ``cfg`` under ``policy``, shapes and
    dtypes only: traced under ``FakeTensorMode`` (meta storage), so the fp32
    model is never built."""
    with FakeTensorMode():
        tmpl, _ = converter.convert(lm_model.init(torch.Generator(), cfg),
                                    policy)
    return tmpl


def load_packed(path: str, template, device: str | torch.device = "cuda"):
    """Read an ``export_packed`` ``.npz`` into ``template``'s tree on
    ``device``.  Every leaf must have its template leaf's shape and dtype
    (``uint32`` words load as the port's ``int32``)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    params = params_from_numpy(_unflatten_into(template, flat), device)

    def check(t, x):
        if x.shape != t.shape or x.dtype != t.dtype:
            raise ValueError(
                f"{path}: a leaf is {x.dtype}{tuple(x.shape)}, the model "
                f"wants {t.dtype}{tuple(t.shape)}")
    tree_map(check, template, params)
    return params


def stream_agreement(got: dict, want: dict) -> tuple[int, int, int | None]:
    """(tokens that agree position by position, tokens in ``want``, index of
    the first differing token in rid order then position, or None)."""
    same = total = 0
    first = None
    for rid in sorted(want):
        a, b = np.asarray(got[rid]), np.asarray(want[rid])
        eq = a[: len(b)] == b[: len(a)]
        same += int(eq.sum())
        if first is None and (not eq.all() or len(a) != len(b)):
            first = total + (int(np.argmin(eq)) if not eq.all() else len(eq))
        total += len(b)
    return same, total, first


def serve(eng: Engine, prompts: list[np.ndarray]):
    """Submit ``prompts`` to a fresh Scheduler; returns (results, seconds,
    scheduler stats)."""
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(Request(prompt=p))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    results = sched.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return results, time.perf_counter() - t0, sched.stats


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="binary",
                    help="binary | binary_scaled | wXaY (DoReFa, e.g. w4a4)")
    ap.add_argument("--backend", choices=("vpu", "mxu", "xla"), default="vpu",
                    help="base GEMM backend; k-bit layers resolve it onto "
                         "the vpu-k*/mxu-k* plane kernels")
    ap.add_argument("--packed", default=None, metavar="PATH",
                    help="serve this packed checkpoint (from train.py "
                         "--export-packed) instead of a seeded model")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to N layers (widths stay)")
    ap.add_argument("--prompts", type=int, default=4,
                    help="requests to serve == scheduler KV-cache slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params (torch.Generator) and prompts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-block-size", type=int, default=None,
                    help="switch the KV cache to the block-table paged "
                         "pool with this block size (must divide "
                         "--cache-len); default contiguous per-slot slabs")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged mode: split prompt prefill into windows "
                         "of this many tokens interleaved with decode "
                         "steps (bounds batchmates' inter-token latency)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="paged mode: hash full prompt blocks at "
                         "admission and reuse already-prefilled blocks "
                         "across identical-prefix requests (every prompt "
                         "gets a common prefix so the savings show up in "
                         "the stats line)")
    ap.add_argument("--fused-attn", action="store_true",
                    help="route decode/window attention through the fused "
                         "flash-decode kernel (no dense KV gather); off = "
                         "the gather + masked-sdpa oracle path")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8, 1],
                    help="KV-cache storage tier: 8 = int8 codes + per-"
                         "(head, dh-group) absmax scales, 1 = sign bytes + "
                         "per-head alpha (the XNOR tier); default fp "
                         "compute dtype")
    ap.add_argument("--check-fakequant", action="store_true",
                    help="also serve the fake-quant float model: assert "
                         "identical greedy tokens at 1 bit (paper §2.2.2), "
                         "report the agreement at k bits")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    policy = parse_quant(args.quant)
    ctx = QCtx(policy=policy, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=args.backend))

    if args.packed:
        if args.check_fakequant:
            raise SystemExit("--check-fakequant needs the float model; a "
                             "--packed checkpoint holds packed words only")
        packed = load_packed(args.packed, packed_template(cfg, policy), dev)
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"device {dev}, quant {args.quant}; loaded packed checkpoint "
              f"{args.packed}")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = lm_model.init(gen, cfg)
        packed, report = converter.convert(params, policy)
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"device {dev}, quant {args.quant}; packed {report.summary()}")
        if not args.check_fakequant:
            del params

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.prompts)]
    if args.shared_prefix:
        # every request opens with the same "system prompt", so later
        # admissions reuse its already-prefilled blocks
        shared = rng.integers(0, cfg.vocab_size,
                              (args.prompt_len,)).astype(np.int32)
        prompts = [np.concatenate([shared, p]) for p in prompts]
    ecfg = EngineConfig(batch=args.prompts, cache_len=args.cache_len,
                        max_new_tokens=args.new_tokens, seed=args.seed,
                        kv_block_size=args.kv_block_size,
                        prefill_chunk=args.prefill_chunk,
                        shared_prefix=args.shared_prefix,
                        fused_attn=args.fused_attn, kv_bits=args.kv_bits)
    eng = Engine(spec, cfg, ctx, packed, ecfg)
    tier = {None: "fp", 8: "int8", 1: "1-bit"}[args.kv_bits]
    print(f"KV cache: {'paged' if eng.paged else 'contiguous'}, {tier} "
          f"storage; decode attention: "
          f"{'fused flash-decode kernel' if args.fused_attn else 'gather'}")
    results, dt, stats = serve(eng, prompts)
    n_tok = sum(len(v) for v in results.values())
    print(f"packed ({args.backend}): {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s), {stats.steps} decode steps, "
          f"{stats.prefills} prefills")
    if eng.paged:
        print(f"paged KV: {stats.prefill_tokens} prompt tokens prefilled, "
              f"{stats.shared_tokens} reused from shared prefix blocks")
    for rid in sorted(results)[:4]:
        print(f"  rid={rid}: {results[rid][:12]}")

    if args.check_fakequant:
        ref, dt_f, _ = serve(Engine(spec, cfg, ctx, params, ecfg), prompts)
        agree, total, first = stream_agreement(results, ref)
        print(f"fake-quant: {total} tokens in {dt_f:.3f}s; packed == "
              f"fake-quant: {first is None} ({agree} of {total} tokens "
              f"agree, first difference at {first})")
        if first is not None and policy.w_bits == 1:
            raise SystemExit("§2.2.2 violated: packed tokens differ from "
                             "the fake-quant tokens")
    return results


if __name__ == "__main__":
    main()
