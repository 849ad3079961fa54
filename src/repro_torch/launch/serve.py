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

``--arch`` resolves through the registry: the dense granite-3-2b,
deepseek-7b and qwen2-72b, or the MoE deepseek-moe-16b / qwen2-moe-a2.7b,
whose packed experts run on the expert-batched kernels (1-bit sign words
on K7 / K8, DoReFa plane stacks on K9 / K10 with ``--quant wXaY``).  The
seeded model is built one block at a time (``lm.init_packed``): each block
is drawn in fp32, packed and freed before the next, so only the packed
model, its float embedding and head, and one float block are ever held.
qwen2-72b at full width (290.8 GB in fp32, about 18.7 GB packed at 1 bit,
both counted from its shapes) thus serves on one 80 GB card without
cutting depth; ``--layers`` still cuts it.  ``--check-fakequant`` serves
the float model too: it draws the whole float model again from the seed,
so it is limited by the model's fp32 bytes.

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
1-bit sign + alpha).  The backend, prologue and attention flags come from
``launch/cli.py``.

``--request-stream`` submits 2 x ``--prompts`` requests of mixed prompt
lengths, so slots recycle as requests finish, and prints the served / TTFT
line, the paged line and the p50 / p95 per-token latency; ``--eos-id``
retires a slot the step it emits that token, and ``--temperature`` samples
(0, the default, is greedy).

``--draft w1a1 --spec-len s`` turns on speculative decoding: the leading
``--draft-layers`` layers (default a quarter) of the seeded float model,
packed to 1 bit (the draft ``converter.derive_draft`` cuts; ``--draft fp``
keeps them float), propose ``s`` tokens a round and the target verifies them in one
window (``serve/engine.py``).  Greedy streams stay those of non-speculative
serving, and a ``speculative:`` line reports the acceptance.  With
``--packed`` the draft still comes from the seeded init, as in the JAX
launcher, and the seeded target's blocks are dropped as they are drawn.
The draft's blocks are packed while ``lm.init_packed`` holds them in
float, so a draft never needs the whole float model either.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --draft w1a1 --spec-len 2 --request-stream
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --backend mxu --prompts 4 --prompt-len 64 --cache-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
      --backend vpu --prompts 1 --prompt-len 8192 --cache-len 8448
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
      --smoke --device cpu --draft w1a1 --check-fakequant
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
from repro_torch.interop import params_from_numpy
from repro_torch.launch import cli
from repro_torch.models import lm as lm_model
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.serve.engine import (DraftModel, Engine, EngineConfig,
                                      Request, Scheduler)
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
    cli.add_gemm_flags(ap, "--backend", "--xnor-backend")
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
                    help="seeds the params (torch.Generator), the prompts "
                         "and the sampling streams")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token: the scheduler retires (and recycles) "
                         "a slot the step it emits this id")
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
    cli.add_attn_flags(ap)
    cli.add_spec_flags(ap)
    ap.add_argument("--request-stream", action="store_true",
                    help="submit 2x --prompts requests of mixed prompt "
                         "lengths (slots recycle as requests finish) and "
                         "print TTFT and per-token latency")
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
               gemm_config=cli.gemm_config_from_args(args))

    if args.packed and args.check_fakequant:
        raise SystemExit("--check-fakequant needs the float model; a "
                         "--packed checkpoint holds packed words only")
    # the draft is cut from the seeded float blocks: a packed target cannot
    # be re-sliced
    n_draft = (converter.draft_depth(cfg.n_layers, args.draft_layers)
               if args.draft else 0)
    dpolicy = parse_quant("binary" if args.draft == "w1a1" else "fp")
    dparams = None
    if not args.packed or args.draft:  # one float block at a time
        # a --packed target comes from its file: only the draft is kept
        packed, report, dparams = lm_model.init_packed(
            torch.Generator(device=dev).manual_seed(args.seed), cfg,
            None if args.packed else policy, draft_layers=n_draft,
            draft_policy=dpolicy)
    # fake-quant serves the whole float model, drawn again from the seed
    params = (lm_model.init(torch.Generator(device=dev).manual_seed(
        args.seed), cfg) if args.check_fakequant else None)
    if args.packed:
        packed = load_packed(args.packed, packed_template(cfg, policy), dev)
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"device {dev}, quant {args.quant}; loaded packed checkpoint "
              f"{args.packed}")
    else:
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"device {dev}, quant {args.quant}; packed {report.summary()}")
    draft = None
    if args.draft:
        dcfg = dataclasses.replace(cfg, n_layers=n_draft)
        draft = DraftModel(cfg=dcfg, params=dparams,
                           ctx=dataclasses.replace(ctx, policy=dpolicy))
        print(f"speculative draft: {dcfg.n_layers}/{cfg.n_layers} layers "
              f"({args.draft}), spec_len={args.spec_len}")

    rng = np.random.default_rng(args.seed)
    n_req = 2 * args.prompts if args.request_stream else args.prompts
    lens = [max(2, args.prompt_len - 2 * (i % 4)) if args.request_stream
            else args.prompt_len for i in range(n_req)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    if args.shared_prefix:
        # every request opens with the same "system prompt", so later
        # admissions reuse its already-prefilled blocks
        shared = rng.integers(0, cfg.vocab_size,
                              (args.prompt_len,)).astype(np.int32)
        prompts = [np.concatenate([shared, p]) for p in prompts]
    ecfg = EngineConfig(batch=args.prompts, cache_len=args.cache_len,
                        max_new_tokens=args.new_tokens,
                        temperature=args.temperature, eos_id=args.eos_id,
                        seed=args.seed, kv_block_size=args.kv_block_size,
                        prefill_chunk=args.prefill_chunk,
                        shared_prefix=args.shared_prefix,
                        fused_attn=args.fused_attn, kv_bits=args.kv_bits,
                        draft=draft, spec_len=args.spec_len)
    eng = Engine(spec, cfg, ctx, packed, ecfg)
    tier = {None: "fp", 8: "int8", 1: "1-bit"}[args.kv_bits]
    print(f"KV cache: {'paged' if eng.paged else 'contiguous'}, {tier} "
          f"storage; decode attention: "
          f"{'fused flash-decode kernel' if args.fused_attn else 'gather'}")
    results, dt, stats = serve(eng, prompts)
    n_tok = sum(len(v) for v in results.values())
    if args.request_stream:
        ttft = np.mean(stats.ttfts()) * 1e3
        print(f"served {len(results)} requests (prompt lens {min(lens)}-"
              f"{max(lens)}) on {args.prompts} slots in {dt:.3f}s: {n_tok} "
              f"tokens ({n_tok / dt:.1f} tok/s), {stats.steps} decode steps, "
              f"{stats.prefills} prefills, mean TTFT {ttft:.1f}ms")
    else:
        print(f"packed ({args.gemm_backend}): {n_tok} tokens in {dt:.3f}s "
              f"({n_tok / dt:.1f} tok/s), {stats.steps} decode steps, "
              f"{stats.prefills} prefills")
    if eng.paged:
        print(f"paged KV: {stats.prefill_tokens} prompt tokens prefilled, "
              f"{stats.shared_tokens} reused from shared prefix blocks")
    if eng.speculative:
        print(f"speculative: {stats.spec_rounds} rounds, acceptance "
              f"{stats.acceptance_rate:.2f} ({stats.spec_accepted}/"
              f"{stats.spec_proposed} proposals accepted)")
    if args.request_stream and stats.tpots():
        p50, p95 = np.percentile(stats.tpots(), [50, 95]) * 1e3
        print(f"per-token latency: p50 {p50:.1f}ms, p95 {p95:.1f}ms")
    for rid in sorted(results)[:4]:
        print(f"  rid={rid} ({len(results[rid])} tok): {results[rid][:12]}")

    if args.check_fakequant:
        # the float model without a draft: speculative streams are held
        # against target-only ones too
        ref, dt_f, _ = serve(Engine(spec, cfg, ctx, params,
                                    dataclasses.replace(ecfg, draft=None)),
                             prompts)
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
