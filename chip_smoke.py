#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bitblas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each (a failure in any phase raises and exits
non-zero; on a host without CUDA it exits 2 and prints no result):

1. env      -- card name and power limit (nvidia-smi), torch and CUDA versions.
2. build    -- nvcc builds csrc/*.cu, one process per source, all at once.
3. kernels  -- each kernel against its plain PyTorch version on the card at
               the slice's shapes: max abs / relative error, kernel_ms,
               plain_ms, library_ms (a PyTorch call computing the same
               function, timed as a yardstick only) and bound_ms (the larger
               of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s, the H100
               SXM data-sheet peaks); the paged kernels also time the
               table-gather path (gather_ms).
4. reference -- a 2-layer model at Llama-2-7B widths: prefill (flash) and
               teacher-forced decode steps on the card against the same
               weights on the CPU plain path; then TokenContinuousBatching-
               Engine(num_slots=4) on both, bf16 and int8 KV, four greedy
               requests in buckets 256/512 (per-step logits, tokens, final
               hidden states); then PagedContinuousBatchingEngine, bf16 and
               int8, four requests of which two share a 256-token prefix
               (per-step block tables, prefix hits, logits of the hidden
               states and their greedy tokens).
5. serve    -- 32-layer W4A16 Llama-2-7B widths (random weights from a
               seeded generator on the card) behind an LMHead (vocab 32000),
               four greedy requests (prompts 200/300/450/500, 32 new tokens)
               on four slots, through
               serve            TokenContinuousBatchingEngine, bf16 KV;
               serve_kv_quant   the same with int8 KV;
               serve_paged      PagedContinuousBatchingEngine (block size
                                16, 64 blocks per slot), bf16, the prompts
                                embedded, plus two requests sharing a
                                256-token prefix;
               serve_paged_quant  the same over the int8 pool.
               Every request finishes, hiddens and logits are finite, and
               every kernel of the phase's path has a launch counter (all
               reset to 0 just before the phase) > 0. A profile of 5 decode
               steps follows each token-engine phase.

Then the kernel summary line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F16_FLOPS_PER_S = 989e12       # dense f16/bf16 tensor core, data sheet


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, flush=None) -> float:
    """Median per-launch device time with CUDA events; `flush` (a buffer
    larger than the 50 MB L2) is rewritten before each launch so weights
    come from HBM as they do on the serving path. A device-side sleep
    queued first keeps the card busy while the host enqueues every
    launch, so no launch waits on the host's wrapper code between its
    two events."""
    fn()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)   # ~25 ms of clock cycles
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in events)
    return ts[len(ts) // 2]


def check_dequant(torch, flush):
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul_u4, dequant_matmul_u4_plain, dequantize_hopper)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for (N, K) in ((4096, 4096), (11008, 4096), (4096, 11008)):
        G = K // 128
        qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen,
                           device="cuda").half()
        Wd = dequantize_hopper(qw, sc, zr)
        for M in (1, 4, 256, 512):
            A = torch.randn((M, K), generator=gen, device="cuda").half()
            out = dequant_matmul_u4(A, qw, sc, zr)
            ref = dequant_matmul_u4_plain(A, qw, sc, zr)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # identical f16 dequantized weights: only the order of the f32
            # sums differs, then one f16 rounding (2^-11 relative)
            tol = 4e-3 * scale
            if not (err <= tol and torch.isfinite(out).all().item()):
                raise AssertionError(f"dequant M={M} N={N} K={K}: max abs "
                                     f"err {err} > {tol}")
            nbytes = M * K * 2 + N * K / 2 + 2 * G * N * 2 + M * N * 2
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
            row = {
                "phase": "kernels", "kernel": "dequant_matmul_u4",
                "M": M, "N": N, "K": K, "max_abs_err": err,
                "max_rel_err": err / max(scale, 1e-30), "tol": tol,
                "kernel_ms": time_ms(torch, lambda: dequant_matmul_u4(
                    A, qw, sc, zr), 20, flush),
                "plain_ms": time_ms(torch, lambda: dequant_matmul_u4_plain(
                    A, qw, sc, zr), 3, flush),
                "library_ms": time_ms(torch, lambda: torch.matmul(A, Wd.T),
                                      20, flush),
                "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def check_flash_attention(torch, flush):
    from bitblas_tpu_torch.kernels.flash import (flash_attention_fwd,
                                                 flash_attention_plain)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []
    B, H, D = 1, 32, 128
    for S in (256, 512):
        Q, K, V = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").half() for _ in range(3))
        out = flash_attention_fwd(Q, K, V)
        ref = flash_attention_plain(Q, K, V)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # P is rounded to f16 before the PV product (2^-11 relative per
        # weight), and the output is one f16 rounding: 1e-2 absolute on
        # outputs of magnitude < 4
        tol = 1e-2
        if not (err <= tol and torch.isfinite(out).all().item()):
            raise AssertionError(f"flash S={S}: max abs err {err} > {tol}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (Q, K, V))
        nbytes = 4 * B * S * H * D * 2
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes, flops)
        row = {
            "phase": "kernels", "kernel": "flash_attention_fwd",
            "B": B, "H": H, "S": S, "D": D, "max_abs_err": err,
            "max_rel_err": err / ref.float().abs().max().item(), "tol": tol,
            "kernel_ms": time_ms(torch, lambda: flash_attention_fwd(Q, K, V),
                                 20, flush),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(Q, K, V),
                                5, flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
    return rows


DECODE_LENGTHS = (1, 37, 513, 1024)


def _decode_row(torch, name, out, ref, tol, timed, extra, flush):
    """Check a decode kernel's output against its plain version and time
    it: `timed` maps a column (kernel_ms, plain_ms, ...) to (fn, iters)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= tol and torch.isfinite(out).all().item()):
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    row = {"phase": "kernels", "kernel": name, **extra, "max_abs_err": err,
           "max_rel_err": err / ref.float().abs().max().item(), "tol": tol}
    for col, (fn, iters) in timed.items():
        row[col] = time_ms(torch, fn, iters, flush)
    emit(row)
    return row


def check_flash_decode(torch, flush):
    from bitblas_tpu_torch.kernels.flash import flash_decode, flash_decode_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    B, H, Hkv, D, Smax, rows_n = 4, 32, 32, 128, 1024, 6
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    kc = torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    for b in range(B):   # stale rows past each length: must never be read
        kc[slots[b], lengths[b]:] = float("nan")
        vc[slots[b], lengths[b]:] = float("nan")
    args = (q, kc, vc, lengths, slots)
    out = flash_decode(*args)
    ref = flash_decode_plain(*args)
    # yardstick: SDPA over the gathered caches with a length mask (the
    # gather itself is outside the timed call)
    kg = kc[slots.long()].transpose(1, 2).half().nan_to_num()
    vg = vc[slots.long()].transpose(1, 2).half().nan_to_num()
    mask = (torch.arange(Smax, device="cuda")[None] < lengths[:, None]
            .long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    nbytes = ltot * Hkv * D * 2 * 2 + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    # f32 softmax both sides; one f16 rounding of |out| < 2
    return _decode_row(
        torch, "flash_decode", out, ref, 2e-3,
        {"kernel_ms": (lambda: flash_decode(*args), 20),
         "plain_ms": (lambda: flash_decode_plain(*args), 5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "Smax": Smax,
         "lengths": lengths.tolist(), "bound_ms": b_ms, "bound_by": b_by},
        flush)


def check_flash_decode_quant(torch, flush):
    """Kernel 6 at Llama-2-7B widths over the int8 slot cache; stale rows
    past each length hold extreme codes and NaN scales."""
    from bitblas_tpu_torch.kernels.flash import (flash_decode_quant,
                                                 flash_decode_quant_plain)
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    B, H, Hkv, D, Smax, rows_n = 4, 32, 32, 128, 1024, 6
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    kc, ks = quantize_kv(torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                                     device="cuda"))
    vc, vs = quantize_kv(torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                                     device="cuda"))
    for b in range(B):
        kc[slots[b], lengths[b]:] = 127
        vc[slots[b], lengths[b]:] = -128
        ks[slots[b], lengths[b]:] = float("nan")
        vs[slots[b], lengths[b]:] = float("nan")
    args = (q, kc, vc, ks, vs, lengths, slots)
    out = flash_decode_quant(*args)
    ref = flash_decode_quant_plain(*args)
    # yardstick: SDPA over the gathered rows, dequantized beforehand
    s = slots.long()
    kg = (kc[s].float() * ks[s][..., None]).nan_to_num().transpose(1, 2) \
        .half()
    vg = (vc[s].float() * vs[s][..., None]).nan_to_num().transpose(1, 2) \
        .half()
    mask = (torch.arange(Smax, device="cuda")[None]
            < lengths[:, None].long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    # live int8 codes + their f32 scales, q in, out out
    nbytes = ltot * Hkv * (2 * D + 2 * 4) + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    # f32 softmax and products on both sides over the same codes; one f16
    # rounding of |out| < 2
    return _decode_row(
        torch, "flash_decode_quant", out, ref, 2e-3,
        {"kernel_ms": (lambda: flash_decode_quant(*args), 20),
         "plain_ms": (lambda: flash_decode_quant_plain(*args), 5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "Smax": Smax,
         "lengths": list(DECODE_LENGTHS), "bound_ms": b_ms,
         "bound_by": b_by}, flush)


def check_flash_decode_paged(torch, flush, quant: bool):
    """Kernel 7 (bf16) or 8 (int8) at Llama-2-7B widths over a block pool
    of 16-row pages through a permuted table; the reserved block 0 and the
    rows past each length in the last page are NaN (NaN scales for int8),
    and table entries past the live pages are 0."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.serving import kv_cache
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9 + quant)
    B, H, Hkv, D, bs, MB = 4, 32, 32, 128, 16, 64
    need = [-(-n // bs) for n in DECODE_LENGTHS]
    blocks = 1 + sum(need) + 27
    perm = torch.randperm(blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    kf, vf = (torch.randn((blocks, bs, Hkv, D), generator=gen, device="cuda")
              for _ in range(2))
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        pools = (k, v, ks, vs)
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
        kernel, plain = flash.flash_decode_paged_quant, \
            flash.flash_decode_paged_quant_plain
        gather = kv_cache.decode_attention_paged_quant
        kd = (k.float() * ks[..., None])
        vd = (v.float() * vs[..., None])
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        pools = (k, v)
        stale = ((k, float("nan")), (v, float("nan")))
        kernel, plain = flash.flash_decode_paged, \
            flash.flash_decode_paged_plain
        gather = kv_cache.decode_attention_paged
        kd, vd = k, v
    for x, val in stale:
        x[0] = val
        for b, n in enumerate(DECODE_LENGTHS):
            if n % bs:
                x[tables[b, n // bs], n % bs:] = val
    args = (q, *pools, tables, lengths)
    out = kernel(*args)
    ref = plain(*args)
    # yardstick: SDPA over the rows gathered through the tables beforehand
    t = tables.long()
    kg, vg = (x[t].reshape(B, MB * bs, Hkv, D).float().nan_to_num()
              .transpose(1, 2).half() for x in (kd, vd))
    mask = (torch.arange(MB * bs, device="cuda")[None]
            < lengths[:, None].long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    per_row = 2 * D + 2 * 4 if quant else 2 * D * 2
    # live rows (+ scales), the live table entries, q in, out out
    nbytes = ltot * Hkv * per_row + sum(need) * 4 + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    name = kernel.__name__
    # f32 softmax and products on both sides over the same stored values;
    # one f16 rounding of |out| < 2
    return _decode_row(
        torch, name, out, ref, 2e-3,
        {"kernel_ms": (lambda: kernel(*args), 20),
         "plain_ms": (lambda: plain(*args), 5),
         "gather_ms": (lambda: gather(*args, num_heads=H, use_flash=False),
                       5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "block_size": bs, "max_blocks": MB,
         "lengths": list(DECODE_LENGTHS), "bound_ms": b_ms,
         "bound_by": b_by}, flush)


def llama2_7b(num_layers: int, hidden: int = 4096, inter: int = 11008,
              heads: int = 32):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # meta-llama/Llama-2-7b-hf config.json widths; uint4 GPTQ, group 128
    return LlamaConfig(hidden_size=hidden, intermediate_size=inter,
                       num_heads=heads, num_kv_heads=heads,
                       num_layers=num_layers, vocab_size=32000,
                       group_size=128, rms_norm_eps=1e-5)


def check_reference(torch):
    """2 layers at full width: the card's path vs the plain CPU path on
    the same weights (prefill at bucket 512 -> flash; 4 decode steps)."""
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    cfg = llama2_7b(2)
    gpu = QuantLlama(cfg, device="cuda", seed=11)
    cpu = QuantLlama(cfg, device="cpu", seed=11)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    S, steps = 512, 4
    x = (torch.randn((1, S, cfg.hidden_size), generator=gen) * 0.5).half()
    pos = torch.arange(S)[None]
    errs = {}
    outs = {}
    for name, model, dev in (("cuda", gpu, "cuda"), ("cpu", cpu, "cpu")):
        hid, ks, vs = model.make_prefill(S)(x.to(dev), pos.to(dev))
        shape = (cfg.num_layers, 1, S + steps, cfg.num_kv_heads,
                 cfg.head_dim)
        ck = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        cv = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        ck[:, 0, :S] = torch.stack(ks).to(torch.bfloat16)
        cv[:, 0, :S] = torch.stack(vs).to(torch.bfloat16)
        hs = [hid[0, -1].float().cpu()]
        slots = torch.zeros((1,), dtype=torch.int32, device=dev)
        for i in range(steps):
            xi = x[:, i:i + 1].to(dev)   # teacher-forced inputs
            lengths = torch.tensor([S + i], dtype=torch.int32, device=dev)
            h, ck, cv = model.decode_step(xi, ck, cv, slots, lengths)
            hs.append(h[0, 0].float().cpu())
        outs[name] = (hid[0].float().cpu(), torch.stack(hs))
    for i, key in enumerate(("prefill_hidden", "decode_hidden")):
        a, b = outs["cuda"][i], outs["cpu"][i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"reference: non-finite {key} on the card")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        errs[key] = {"max_abs_err": err, "max_rel_err": err / scale}
        # f16 activations through 2 layers (14 GEMMs, 2 attentions): a
        # few f16 ulps of the largest value per op, summed
        if err > 2e-2 * scale:
            raise AssertionError(f"reference {key}: {err} > 2e-2 * {scale}")
    emit({"phase": "reference", "layers": 2, "prompt": S,
          "decode_steps": steps, **errs})
    compare_engines(torch, cfg, gpu, cpu)
    compare_engines(torch, cfg, gpu, cpu, kv_quant=True)
    compare_paged(torch, cfg, gpu, cpu, kv_quant=False)
    compare_paged(torch, cfg, gpu, cpu, kv_quant=True)
    del gpu, cpu
    torch.cuda.empty_cache()


def _reference_heads(torch, cfg):
    """An LMHead on the card and one on the CPU with the same seeded
    weights (vocab 32000)."""
    from bitblas_tpu_torch.models.hf_import import LMHead
    gen = torch.Generator(device="cpu")
    gen.manual_seed(6)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    embed = (torch.randn((V, Hd), generator=gen) * 0.05).half()
    lm_head = torch.randn((V, Hd), generator=gen) * 0.05
    return {dev: LMHead(embed, torch.ones(Hd), lm_head,
                        norm_eps=cfg.rms_norm_eps, device=dev)
            for dev in ("cuda", "cpu")}


def compare_engines(torch, cfg, gpu, cpu, kv_quant: bool = False):
    """TokenContinuousBatchingEngine with four live slots, on the card and
    on the CPU with the same weights: prompts in buckets 256 and 512, and
    budgets that release slots while others still decode. Each request's
    logits agree step by step while its greedy tokens agree; tokens may
    part only where the CPU's logits are a near-tie, and with every token
    equal the final hidden states agree too. Catches a mix-up of slots or
    lengths in the engine or the decode path that one sequence cannot."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import TokenContinuousBatchingEngine

    heads = _reference_heads(torch, cfg)
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (200, 300, 450, 500)]
    budgets = (4, 8, 6, 8)
    runs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        head = heads[dev]
        eng = TokenContinuousBatchingEngine(model, head, num_slots=4,
                                            max_seq_len=1024,
                                            kv_quant=kv_quant)
        rows = {}
        sample = eng._sample

        def recording_sample(req, logits_row, rows=rows, sample=sample):
            rows.setdefault(req.uid, []).append(logits_row.copy())
            return sample(req, logits_row)

        eng._sample = recording_sample
        reqs = [eng.submit_tokens(uid=i, tokens=p, max_new=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        eng.run_to_completion()
        if not all(r.done and len(r.out_tokens) == r.max_new for r in reqs):
            raise AssertionError(f"reference engine on {dev}: a request "
                                 f"did not finish")
        runs[dev] = (reqs, rows)
    logit_err, hidden_err, same = 0.0, 0.0, []
    for rc, rp in zip(*(runs[d][0] for d in ("cuda", "cpu"))):
        lc, lp = runs["cuda"][1][rc.uid], runs["cpu"][1][rp.uid]
        for i, (tc, tp) in enumerate(zip(rc.out_tokens, rp.out_tokens)):
            if not np.isfinite(lc[i]).all():
                raise AssertionError(f"reference engine: non-finite logits "
                                     f"on the card, request {rc.uid}")
            err = float(np.abs(lc[i] - lp[i]).max())
            # the logits inherit the hidden states' few f16 ulps
            tol = 2e-2 * float(np.abs(lp[i]).max())
            if err > tol:
                raise AssertionError(f"reference engine: request {rc.uid} "
                                     f"step {i} logits {err} > {tol}")
            logit_err = max(logit_err, err)
            if tc != tp:   # a near-tie, given the logits agree: the next
                break      # steps feed different tokens
        same.append(rc.out_tokens == rp.out_tokens)
        if same[-1]:
            err = float(np.abs(rc.final_hidden - rp.final_hidden).max())
            scale = float(np.abs(rp.final_hidden).max())
            if err > 2e-2 * scale:
                raise AssertionError(f"reference engine: request {rc.uid} "
                                     f"final hidden {err} > 2e-2 * {scale}")
            hidden_err = max(hidden_err, err)
    emit({"phase": "reference_engine" + ("_kv_quant" if kv_quant else ""),
          "layers": 2, "num_slots": 4,
          "prompts": [len(p) for p in prompts], "max_new": list(budgets),
          "tokens_equal": same, "max_logit_abs_err": logit_err,
          "final_hidden_max_abs_err": hidden_err})


def compare_paged(torch, cfg, gpu, cpu, kv_quant: bool):
    """PagedContinuousBatchingEngine (block size 16, four slots) on the
    card and on the CPU with the same weights: embedded prompts of 200 and
    300 tokens and two that share a 256-token prefix, budgets that release
    slots at different steps. After every step the block tables and prefix
    hits are identical, and each live request's hidden state gives logits
    within 2e-2 x max |logit| of the CPU's; its greedy token (argmax) is
    reported per request."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine, Request)

    heads = _reference_heads(torch, cfg)
    V = cfg.vocab_size
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, V, 256)
    prompts = [rng.integers(0, V, n) for n in (200, 300)] + [
        np.concatenate([prefix, rng.integers(0, V, n)]) for n in (40, 90)]
    budgets = (4, 8, 6, 8)
    runs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        head = heads[dev]
        eng = PagedContinuousBatchingEngine(
            model, num_slots=4, num_blocks=1 + 4 * 64, block_size=16,
            max_blocks_per_slot=64, kv_quant=kv_quant)
        reqs = [Request(uid=i, prompt=head.embed_tokens(p), max_new=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        for r in reqs:
            eng.submit(r)
        tables, logits = [], {}
        while eng.active or eng.pending:
            eng.step()
            tables.append(eng.tables.copy())
            rows = head.logits(eng.last_hidden.float()).cpu().numpy()
            for slot, r in eng.active.items():
                logits.setdefault(r.uid, []).append(rows[slot])
        for r in reqs:
            if not (r.done and np.isfinite(r.final_hidden).all()):
                raise AssertionError(f"reference paged on {dev}: request "
                                     f"{r.uid} did not finish cleanly")
            logits.setdefault(r.uid, []).append(head.logits(torch.tensor(
                r.final_hidden, device=head.embed.device)[None])
                .cpu().numpy()[0])
        runs[dev] = (tables, logits, eng.prefix_hits)
    (tc, lc, hc), (tp, lp, hp) = runs["cuda"], runs["cpu"]
    if len(tc) != len(tp) or not all(np.array_equal(a, b)
                                     for a, b in zip(tc, tp)):
        raise AssertionError("reference paged: block tables differ")
    if hc != hp or hc <= 0:
        raise AssertionError(f"reference paged: prefix hits {hc} vs {hp}")
    logit_err, same = 0.0, []
    for uid in sorted(lp):
        if len(lc[uid]) != len(lp[uid]):
            raise AssertionError(f"reference paged: request {uid} steps")
        for a, b in zip(lc[uid], lp[uid]):
            if not np.isfinite(a).all():
                raise AssertionError("reference paged: non-finite logits")
            err = float(np.abs(a - b).max())
            if err > 2e-2 * float(np.abs(b).max()):
                raise AssertionError(f"reference paged: request {uid} "
                                     f"logits {err}")
            logit_err = max(logit_err, err)
        same.append([int(a.argmax()) for a in lc[uid]]
                    == [int(b.argmax()) for b in lp[uid]])
    emit({"phase": "reference_paged" + ("_quant" if kv_quant else ""),
          "layers": 2, "num_slots": 4, "block_size": 16,
          "prompts": [len(p) for p in prompts], "max_new": list(budgets),
          "steps": len(tc), "prefix_hits": hc, "tables_equal": True,
          "tokens_equal": same, "max_logit_abs_err": logit_err})


def serving_model(torch):
    """The 32-layer model on the card, its LMHead, the four token prompts
    of every serve phase and the pair that shares a 256-token prefix."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama

    cfg = llama2_7b(32)
    t0 = time.perf_counter()
    model = QuantLlama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (200, 300, 450, 500)]
    prefix = rng.integers(0, V, 256)
    pair = [np.concatenate([prefix, rng.integers(0, V, n)]).astype(np.int32)
            for n in (40, 90)]
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": pair, "init_s": time.perf_counter() - t0}


# phase -> (engine, engine options, the kernels its path must launch)
SERVE_PHASES = (
    ("serve", "token", {}, ("flash_decode",)),
    ("serve_kv_quant", "token", {"kv_quant": True}, ("flash_decode_quant",)),
    ("serve_paged", "paged", {}, ("flash_decode_paged",)),
    ("serve_paged_quant", "paged", {"kv_quant": True},
     ("flash_decode_paged_quant",)),
)
MAX_NEW = 32


def serve(torch, ctx, counters, phase, kind, kw, expect):
    """One serve phase: every launch counter reset to 0, the requests
    submitted and the engine stepped to the end (a sync after each step so
    each step's wall time is its own), the counters read. Steps that
    admitted nothing give the decode metrics; steps that admitted requests
    give prefill tokens/s (their time less one mean decode step)."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine, Request,
        TokenContinuousBatchingEngine, TokenRequest)

    model, head = ctx["model"], ctx["head"]
    if kind == "token":
        eng = TokenContinuousBatchingEngine(model, head, num_slots=4,
                                            max_seq_len=1024, **kw)

        def submit():
            return [eng.submit_tokens(uid=i, tokens=p, max_new=MAX_NEW)
                    for i, p in enumerate(ctx["prompts"])]
    else:
        eng = PagedContinuousBatchingEngine(
            model, num_slots=4, num_blocks=1 + 4 * 64, block_size=16,
            max_blocks_per_slot=64, **kw)

        def submit():
            reqs = [Request(uid=i, prompt=head.embed_tokens(p),
                            max_new=MAX_NEW)
                    for i, p in enumerate(ctx["prompts"] + ctx["pair"])]
            for r in reqs:
                eng.submit(r)
            return reqs
    kv_bytes = sum(t.numel() * t.element_size() for t in (
        eng.caches_k, eng.caches_v, *((eng.scales_k, eng.scales_v)
                                      if kw.get("kv_quant") else ())))

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = submit()
    steps = []          # (seconds, prompt tokens admitted, tokens decoded)
    while eng.active or eng.pending:
        waiting = list(eng.pending)
        made = sum(r.generated for r in reqs)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        admitted = [r for r in waiting if r not in eng.pending]
        first = sum(isinstance(r, TokenRequest) for r in admitted)
        steps.append((dt, sum(len(r.prompt) for r in admitted),
                      sum(r.generated for r in reqs) - made - first))
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    if not all(r.done and r.generated == MAX_NEW for r in reqs):
        raise AssertionError(f"{phase}: a request did not finish")
    if not all(np.isfinite(r.final_hidden).all() for r in reqs):
        raise AssertionError(f"{phase}: non-finite hidden state")
    final_logits = head.logits(torch.tensor(
        np.stack([r.final_hidden for r in reqs]), device=head.embed.device))
    if not torch.isfinite(final_logits).all():
        raise AssertionError(f"{phase}: non-finite logits at completion")
    need = ("dequant_matmul_u4", "flash_attention_fwd") + expect
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"{phase}: a kernel was not launched: "
                             f"{launches}")
    pure = [(dt, n) for dt, adm, n in steps if adm == 0]
    step_s = sum(dt for dt, _ in pure) / max(len(pure), 1)
    adm = [(dt, a) for dt, a, _ in steps if a > 0]
    row = {"phase": phase, "model": "Llama-2-7B widths, W4A16 g128",
           "layers": ctx["cfg"].num_layers, "num_slots": 4,
           "engine": type(eng).__name__, **kw,
           "prompts": [len(r.prompt) for r in reqs], "max_new": MAX_NEW,
           "init_s": ctx["init_s"], "first_step_s": steps[0][0],
           "steps": len(steps), "decode_steps": len(pure),
           "decode_step_ms": step_s * 1e3,
           "decode_tok_s": sum(n for _, n in pure)
           / max(sum(dt for dt, _ in pure), 1e-9),
           "prefill_tok_s": sum(a for _, a in adm)
           / max(sum(dt - step_s for dt, _ in adm), 1e-9),
           "wall_s": wall, "launches": launches,
           "peak_mem_gb": peak / 2 ** 30, "kv_bytes": kv_bytes}
    if kind == "token":
        row["sample_tokens"] = reqs[0].out_tokens[:8]
    else:
        row["prefix_hits"] = eng.prefix_hits
        if eng.prefix_hits <= 0:
            raise AssertionError(f"{phase}: no prefix hit")
    emit(row)
    if kind == "token":
        profile_decode(torch, eng, ctx["prompts"], phase)
    del eng
    torch.cuda.empty_cache()
    return launches


def profile_decode(torch, eng, prompts, phase: str, steps: int = 5):
    """Where a decode step's time goes: torch.profiler over a few decode
    steps at 4 active slots, after the timed run (the profiler slows the
    host, so the busy share it reports is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.submit_tokens(uid=100 + i, tokens=p, max_new=steps + 2)
    eng.step()               # admission (prefill) stays out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.key, ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    emit({"phase": "profile", "of": phase, "decode_steps": steps,
          "wall_ms_per_step": wall_us / steps / 1e3,
          "device_ms_per_step": device_us / steps / 1e3,
          "device_busy_share": device_us / wall_us if kernels else None,
          "kernel_launches_per_step": sum(c for *_, c in kernels) / steps,
          "top_kernels_ms_per_step": {name[:70]: t / steps / 1e3
                                      for name, t, _ in top}})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    try:
        from bitblas_tpu_torch.kernels import build, flash
        from bitblas_tpu_torch.kernels.dequant_matmul import dequant_matmul_u4
    except ImportError as e:
        print(f"chip_smoke: run from the root of a bitblas_tpu checkout "
              f"({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})
    print(smi, flush=True)

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log["log"]
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()},
          "ptxas": ptxas})

    torch.manual_seed(0)
    warm = torch.randn((8192, 8192), device="cuda").half()
    # bring the clocks up, and take the timer's first-call costs, before
    # the first measurement
    time_ms(torch, lambda: warm @ warm, 200)
    del warm
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    dq = check_dequant(torch, flush)
    fa = check_flash_attention(torch, flush)
    fd = check_flash_decode(torch, flush)
    fq = check_flash_decode_quant(torch, flush)
    fp = check_flash_decode_paged(torch, flush, quant=False)
    fpq = check_flash_decode_paged(torch, flush, quant=True)
    del flush
    check_reference(torch)

    counters = (dequant_matmul_u4, flash.flash_attention_fwd,
                flash.flash_decode, flash.flash_decode_quant,
                flash.flash_decode_paged, flash.flash_decode_paged_quant)
    ctx = serving_model(torch)
    launches = {c.__name__: 0 for c in counters}
    for phase in SERVE_PHASES:
        for name, n in serve(torch, ctx, counters, *phase).items():
            launches[name] += n

    def pick(rows, **where):
        return next(r for r in rows
                    if all(r[k] == v for k, v in where.items()))

    lens = "lengths 1/37/513/1024"
    summary = [
        ("dequant_matmul_u4", "dequant_matmul.cu", "dequant_matmul.py:231",
         dq, pick(dq, M=4, N=11008, K=4096), "M=4 N=11008 K=4096"),
        ("flash_attention_fwd", "flash_attention.cu", "flash.py:106",
         fa, pick(fa, S=512), "B=1 H=32 S=512 D=128 causal"),
        ("flash_decode", "flash_decode.cu", "flash.py:456",
         [fd], fd, f"B=4 H=32 Smax=1024 {lens}"),
        ("flash_decode_quant", "flash_decode_quant.cu", "flash.py:648",
         [fq], fq, f"B=4 H=32 Smax=1024 int8 {lens}"),
        ("flash_decode_paged", "flash_decode_paged.cu", "flash.py:874",
         [fp], fp, f"B=4 H=32 bs=16 MB=64 bf16 {lens}"),
        ("flash_decode_paged_quant", "flash_decode_paged_quant.cu",
         "flash.py:1020", [fpq], fpq, f"B=4 H=32 bs=16 MB=64 int8 {lens}"),
    ]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"bitblas_tpu_torch/csrc/{src}",
        "replaces": f"bitblas_tpu/kernels/{rep}",
        "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "shape": shape,
        **({"gather_ms": row["gather_ms"]} if "gather_ms" in row else {})}
        for name, src, rep, rows, row, shape in summary]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
