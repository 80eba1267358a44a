"""Rank code of the port's distributed tests (run by testing/dist.run_world
in every rank; this module imports only torch and the port).

Each `*_world(rank, world_size, ...)` runs a list of cases, each a dict
with a "name", a "tp" (the ranks that take part: the first tp of the
world, as a process subgroup where tp < world_size) and its inputs as
numpy arrays, all on the CPU; it returns {name: outputs} with numpy
outputs of this rank (empty for a case it sits out). Every rank creates
every subgroup, in the same order, as torch.distributed requires.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.quant_llama import LlamaConfig, QuantLlama
from ..ops.matmul_config import MatmulConfig
from ..ops.weight_transform import (DeviceWeights,
                                    transform_reference_operands)
from ..serving import kv_cache as kvc
from ..serving.engine import (ContinuousBatchingEngine,
                              PagedContinuousBatchingEngine, Request)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _groups(world_size: int, cases) -> dict:
    """{tp: the process group of ranks [0, tp)} (None: the whole world)."""
    return {tp: None if tp == world_size
            else dist.new_group(list(range(tp)))
            for tp in sorted({c["tp"] for c in cases})}


def _device_weights(cfg: MatmulConfig, case) -> DeviceWeights:
    """Device-layout weights of the case's reference-layout operands."""
    return transform_reference_operands(cfg, case["qweight"],
                                        case.get("scales"),
                                        case.get("zeros"))


def matmul_world(rank: int, world_size: int, cases) -> dict:
    """The column- and row-parallel matmuls: case "kind" is "column" (out
    N-sharded, gathered here by the test), "column_gather", "row",
    "row_scatter" (this rank's N shard) or "row_overlap" (with "chunks");
    "refuse" checks that a row shard is refused (returns its message);
    "layer" runs TPQuantLlamaLayer + tp_layer_forward."""
    from .. import parallel as par
    from ..parallel.layers import TPQuantLlamaLayer, tp_layer_forward
    groups = _groups(world_size, cases)
    out = {}
    for c in cases:
        if rank >= c["tp"]:
            continue
        g = groups[c["tp"]]
        if c["kind"] == "layer":
            layer = TPQuantLlamaLayer(LlamaConfig(**c["cfg"]), g,
                                      m=c["x"].shape[1], seed=c["seed"],
                                      device="cpu")
            out[c["name"]] = _np(tp_layer_forward(
                layer, torch.from_numpy(c["x"]),
                torch.from_numpy(c["positions"])))
            continue
        cfg = MatmulConfig(**c["config"])
        if c["kind"] == "refuse":
            try:
                par.check_row_shard(cfg, c["tp"])
                out[c["name"]] = None
            except ValueError as e:
                out[c["name"]] = str(e)
            continue
        dw = _device_weights(cfg, c)
        A = torch.from_numpy(c["A"])
        m = A.shape[0]
        if c["kind"].startswith("column"):
            w = par.shard_weights_column(dw, cfg, g)
            fn = par.make_column_parallel_matmul(
                cfg, m, g, gather_output=c["kind"] == "column_gather",
                device="cpu")
            y = fn(A, w.qweight, w.scales, w.zeros)
        else:
            w = par.shard_weights_row(dw, cfg, g)
            k = cfg.K // c["tp"]
            fn = par.make_row_parallel_matmul(
                cfg, m, g, reduce_scatter=c["kind"] == "row_scatter",
                overlap_chunks=c.get("chunks", 1), device="cpu")
            y = fn(A[:, rank * k:(rank + 1) * k].contiguous(), w.qweight,
                   w.scales, w.zeros)
        out[c["name"]] = _np(y)
    return out


# -- tensor-parallel serving ---------------------------------------------------

def _source(case) -> QuantLlama:
    cfg = LlamaConfig(**case["cfg"])
    model = QuantLlama(cfg, device="cpu")
    model.load_state_dict(case["state"])
    return model


def _rank_cache(tpm, t: np.ndarray) -> torch.Tensor:
    """This rank's part of a global cache array [L, slots, S, Hkv(, D)]
    over SOURCE KV heads: its effective heads (source heads replicated
    kv_rep times), or under context parallelism its source head and rows."""
    x = torch.from_numpy(np.ascontiguousarray(t))
    if tpm.context_parallel:
        n_outer = tpm.tp // tpm.cp
        x = kvc.shard_kv_cache({"k": x}, tpm.rank // tpm.cp, n_outer, 3)["k"]
        return kvc.shard_kv_cache({"k": x}, tpm.cp_index, tpm.cp, 2)["k"]
    x = x.repeat_interleave(tpm.kv_rep, dim=3)
    return kvc.shard_kv_cache({"k": x}, tpm.rank, tpm.tp, 3)["k"]


def _engine_run(model, case):
    """A slot or paged engine over `model`, the case's prompts, to the
    end: (each request's final hidden by uid, the engine's last hidden)."""
    if case.get("paged"):
        eng = PagedContinuousBatchingEngine(
            model, num_slots=case.get("slots", 4), num_blocks=32,
            block_size=4, kv_quant=case.get("kv_quant", False))
    else:
        eng = ContinuousBatchingEngine(model, num_slots=4, max_seq_len=32,
                                       kv_quant=case.get("kv_quant", False))
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new=case["max_new"]))
    done = eng.run_to_completion(max_steps=60)
    return ({r.uid: r.final_hidden for r in done},
            _np(eng.last_hidden))


def _serve_case(rank, tpm, src, c):
    """One case's outputs: the TP model's and (rank 0) the single-device
    model's, on the same inputs."""
    kind = c["kind"]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if kind == "prefill":
        S = c["x"].shape[1]
        pos = torch.arange(S)[None]
        h, ks, vs = tpm.make_prefill(S)(T(c["x"]), pos)
        res = {"hidden": _np(h), "k": np.stack([_np(k) for k in ks])}
        if rank == 0:
            hr, ksr, _ = src.make_prefill(S)(T(c["x"]), pos)
            res.update(ref_hidden=_np(hr),
                       ref_k=np.stack([_np(k) for k in ksr]))
        return res
    if kind == "engine":
        fin, last = _engine_run(tpm, c)
        res = {"final": fin, "last": last}
        if rank == 0:
            res["ref_final"], res["ref_last"] = _engine_run(src, c)
        return res
    x, slots, lengths = T(c["x"]), T(c["slots"]), T(c["lengths"])
    chunk = x.shape[1] > 1
    if kind == "quant":
        codes = [kvc.quantize_kv(T(c[n]).to(torch.bfloat16).float())
                 for n in ("ck", "cv")]
        caches = [_rank_cache(tpm, _np(a)).to(torch.int8)
                  for a in (codes[0][0], codes[1][0])] + \
                 [_rank_cache(tpm, _np(s)) for s in (codes[0][1],
                                                     codes[1][1])]
        step = tpm.decode_chunk_quant if chunk else tpm.decode_step_quant
    else:
        caches = [_rank_cache(tpm, c[n]).to(torch.bfloat16)
                  for n in ("ck", "cv")]
        step = tpm.decode_chunk if chunk else tpm.decode_step
    y, *outs = step(x, *caches, slots, lengths)
    res = {"y": _np(y), "ck": _np(outs[0]), "cv": _np(outs[1])}
    if rank == 0 and kind == "decode":
        ref = (src.decode_chunk if chunk else src.decode_step)(
            x, T(c["ck"]).to(torch.bfloat16), T(c["cv"]).to(torch.bfloat16),
            slots, lengths)
        res.update(ref_y=_np(ref[0]), ref_ck=_np(ref[1]),
                   ref_cv=_np(ref[2]))
        if src.cfg.sliding_window is not None:   # the same step unwindowed
            src.cfg = dataclasses.replace(src.cfg, sliding_window=None)
            res["ref_y_nowindow"] = _np((src.decode_chunk if chunk
                                         else src.decode_step)(
                x, T(c["ck"]).to(torch.bfloat16),
                T(c["cv"]).to(torch.bfloat16), slots, lengths)[0])
    return res


def tp_serving_world(rank: int, world_size: int, cases) -> dict:
    """TPQuantLlama cases: case "kind" is "decode" (decode_step, or
    decode_chunk for T > 1, on the float cache; with the single-device
    reference), "quant" (the int8 cache quantized from the same arrays),
    "prefill", "engine" (slot or paged, float or int8) or "refuse" (the
    constructor's error); "tp_kw" the TPQuantLlama options. Caches come
    as global source-head arrays; each rank returns its shard of them."""
    from ..parallel.serving import TPQuantLlama
    groups = _groups(world_size, cases)
    out = {}
    for c in cases:
        if rank >= c["tp"]:
            continue
        src = _source(c)
        if c["kind"] == "refuse":
            # the constructor's error, or with "paged" the paged engine's
            # over the model (its cache shape, or its first decode step)
            try:
                tpm = TPQuantLlama(src, groups[c["tp"]],
                                   **c.get("tp_kw", {}))
                if c.get("paged"):
                    _engine_run(tpm, c)
                out[c["name"]] = None
            except (NotImplementedError, ValueError) as e:
                out[c["name"]] = f"{type(e).__name__}: {e}"
            continue
        tpm = TPQuantLlama(src, groups[c["tp"]], **c.get("tp_kw", {}))
        res = _serve_case(rank, tpm, src, c)
        res["allreduces"] = tpm.allreduces
        out[c["name"]] = res
    return out


# -- expert and pipeline parallelism ----------------------------------------------

def moe_world(rank: int, world_size: int, cases) -> dict:
    """EPQuantMoELayer / expert_parallel_mixtral cases: "layer" (a
    QuantMoELayer's state and x [T, H]: the EP output, and on rank 0 the
    single-device layer's) or "mixtral" (a QuantMixtral's state, an LM
    head and a prompt: the EP model's greedy tokens, and on rank 0 the
    single-device model's)."""
    from ..models.hf_import import LMHead, QuantLlamaLM
    from ..models.quant_moe import (MixtralConfig, MoEConfig, QuantMixtral,
                                    QuantMoELayer)
    from ..parallel.moe import EPQuantMoELayer, expert_parallel_mixtral
    groups = _groups(world_size, cases)
    out = {}
    for c in cases:
        if rank >= c["tp"]:
            continue
        g = groups[c["tp"]]
        if c["kind"] == "layer":
            layer = QuantMoELayer(MoEConfig(**c["cfg"]), c["tokens"],
                                  device="cpu")
            layer.load_state_dict(c["state"])
            x = torch.from_numpy(c["x"]).to(torch.float16)
            ep = EPQuantMoELayer(layer, g)
            res = {"y": _np(ep.forward(x)), "allreduces": ep.allreduces}
            if rank == 0:
                res["ref_y"] = _np(layer.forward(x))
        else:
            cfg = MixtralConfig(**c["cfg"])
            model = QuantMixtral(cfg, device="cpu", opt_m=(1, 4, 8, 16),
                                 moe_tokens=16)
            model.load_state_dict(c["state"])
            head = LMHead(c["embed"], np.ones(cfg.hidden_size, np.float32),
                          c["lm_head"], device="cpu")
            lm = QuantLlamaLM(model, head)
            res = {}
            if rank == 0:
                res["ref_tokens"] = lm.generate(c["prompt"],
                                                max_new_tokens=c["max_new"])
            expert_parallel_mixtral(model, g)
            res["tokens"] = lm.generate(c["prompt"],
                                        max_new_tokens=c["max_new"])
        out[c["name"]] = res
    return out


def _stage_params(cfg: MatmulConfig, layers):
    """{"qweight" [L, N, K/8], "scales" [L, K/g, N]} from each layer's
    reference-layout (qweight, scales)."""
    dws = [_device_weights(cfg, {"qweight": q, "scales": s})
           for q, s in layers]
    return {"qweight": torch.stack([d.qweight for d in dws]),
            "scales": torch.stack([d.scales for d in dws])}


def pipeline_world(rank: int, world_size: int, cases) -> dict:
    """make_gpipe_fn over make_quant_stage_fn: case "stages" holds each
    stage's layers' reference-layout (qweight, scales), "xs" the
    microbatches; returns the pipeline's outputs and, on rank 0, every
    stage applied in turn on this rank alone."""
    from ..parallel.pipeline import (make_gpipe_fn, make_quant_stage_fn,
                                     stack_stage_params)
    groups = _groups(world_size, cases)
    out = {}
    for c in cases:
        if rank >= c["tp"]:
            continue
        cfg = MatmulConfig(**c["config"])
        stages = [_stage_params(cfg, layers) for layers in c["stages"]]
        stage_fn = make_quant_stage_fn(cfg, c["m"], len(c["stages"][0]),
                                       device="cpu")
        params = stack_stage_params(stages, groups[c["tp"]])
        xs = torch.from_numpy(c["xs"])
        res = {"ys": _np(make_gpipe_fn(stage_fn, groups[c["tp"]])(params,
                                                                  xs))}
        if rank == 0:
            ref = []
            for x in xs:
                for p in stages:
                    x = stage_fn(p, x)
                ref.append(x)
            res["ref_ys"] = _np(torch.stack(ref))
        out[c["name"]] = res
    return out
