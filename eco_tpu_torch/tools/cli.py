"""``eco`` command-line interface on PyTorch -- tools/caffe.cpp parity.

Twin of ``eco_tpu/tools/cli.py``, with the same subcommands, flags and
printed lines:

  train        --solver solver.prototxt [--net x.prototxt | --zoo name]
               [--weights a.npz,b.npz | --caffe-weights a.caffemodel,...]
               [--snapshot state.solverstate.npz] [--list train.txt]
  test         --net ... --weights m.model.npz --list val.txt --iterations N
  time         --zoo eco_lite_kinetics [--batch N --segments S --iters K]
  device-query
  convert      --caffemodel m.caffemodel --net deploy.prototxt -o m.model.npz
  parity       --caffemodel m.caffemodel --net deploy.prototxt
  fold         --net ... --weights m.model.npz -o folded  (gen_bn_inference)
  quantize     --net ... --weights m.model.npz --list calib.txt -o int8model
  export       --net ... --weights m.model.npz -o m.caffemodel
  plot, upgrade, convert-imageset, draw, online, extract

  aot          --net ... --weights m.model.npz -o m.pt2  (torch.export artifact)

Every command that runs a model takes ``--device`` (default ``cuda``): the
card unless the caller names another device, with no fallback.  ``train``
and ``test`` take ``--dp N`` / ``--tp N``: one rank per device, data
parallel with SyncBN (x tensor parallel), NCCL on cards and gloo on the
CPU.  Under ``torchrun`` (``WORLD_SIZE`` set) each process is a rank;
otherwise the command spawns the ``dp x tp`` ranks itself.

Run as ``python -m eco_tpu_torch.tools.cli <cmd> ...``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

def _build_graph(args, *, with_loss: bool):
    from eco_tpu_torch.models import get_model
    from eco_tpu_torch.spec.prototxt import graph_from_prototxt

    if getattr(args, "zoo", None):
        kw = {}
        if getattr(args, "crop", None):
            kw["crop_size"] = args.crop
        return get_model(
            args.zoo,
            num_segments=args.segments,
            with_loss=with_loss,
            batch=args.batch,
            **kw,
        )
    if getattr(args, "net", None):
        if args.net.endswith(".json"):  # persisted GraphSpec (e.g. eco fold)
            from eco_tpu_torch.spec.graph import graph_from_json

            return graph_from_json(open(args.net).read())
        return graph_from_prototxt(open(args.net).read())
    raise SystemExit("need --zoo or --net")


def _data_cfg_from_graph(graph, phase: str, list_override=None, args=None):
    """VideoDataConfig from the graph's VideoData layer, DBDataConfig from a
    classic ``Data`` layer (LMDB/LevelDB), or a default config built from
    CLI args when the graph has none (--zoo graphs)."""
    from eco_tpu_torch.data import TransformConfig, VideoDataConfig

    for l in graph.layers:
        if l.type == "data" and l.phase in (None, phase):
            # classic Data layer (data_layer.cpp): Datum database cursor.
            # mean_file (a BlobProto mean image) reduces to per-channel means
            from eco_tpu_torch.data.db import DBDataConfig

            t = dict(l.opt("transform", {}) or {})
            if "mean_file" in t:
                from eco_tpu_torch.convert.caffemodel import load_blobproto

                mimg = load_blobproto(str(t["mean_file"]))
                mv = tuple(
                    float(m) for m in
                    mimg.reshape(mimg.shape[0], -1).mean(axis=1)
                ) if mimg.ndim >= 3 else tuple(float(m) for m in mimg.ravel())
            else:
                mv = t.get("mean_value", (0.0,))
                if not isinstance(mv, (list, tuple)):
                    mv = (mv,)
            crop = int(t.get("crop_size", 0))
            tc = TransformConfig(
                crop_size=crop,
                mirror=bool(t.get("mirror", False)),
                fix_crop=False, more_fix_crop=False, multi_scale=False,
                mean_values=tuple(float(m) for m in mv),
                scale=float(t.get("scale", 1.0)),
            )
            backend = str(l.opt("backend", "")).lower() or None
            return DBDataConfig(
                source=list_override or str(l.opt("source", "")),
                batch_size=int(l.opt("batch_size", 8)),
                backend=backend,
                transform=tc,
            )
        if l.type == "videodata" and l.phase in (None, phase):
            t = dict(l.opt("transform", {}) or {})
            mv = t.get("mean_value", (104, 117, 123))
            if not isinstance(mv, (list, tuple)):
                mv = (mv,)
            tc = TransformConfig(
                crop_size=int(t.get("crop_size", 224)),
                mirror=bool(t.get("mirror", False)),
                fix_crop=bool(t.get("fix_crop", False)),
                more_fix_crop=bool(t.get("more_fix_crop", False)),
                multi_scale=bool(t.get("multi_scale", False)),
                max_distort=int(t.get("max_distort", 1)),
                scale_ratios=tuple(t.get("scale_ratios", (1, 0.875, 0.75, 0.66))),
                is_flow=bool(t.get("is_flow", False)),
                mean_values=tuple(float(m) for m in mv[:3]),
                scale=float(t.get("scale", 1.0)),
            )
            return VideoDataConfig(
                source=list_override or str(l.opt("source", "")),
                batch_size=int(l.opt("batch_size", 8)),
                new_length=int(l.opt("new_length", 1)),
                num_segments=int(l.opt("num_segments", 16)),
                modality=str(l.opt("modality", "RGB")),
                shuffle=bool(l.opt("shuffle", False)),
                name_pattern=str(l.opt("name_pattern", "img_%04d.jpg")),
                new_height=int(l.opt("new_height", 0)),
                new_width=int(l.opt("new_width", 0)),
                step=int(l.opt("step", 1)),
                rand_step=bool(l.opt("rand_step", False)),
                transform=tc,
            )
    if list_override and args is not None:
        # --zoo path: standard ECO defaults (224 crop, BGR means)
        return VideoDataConfig(
            source=list_override,
            batch_size=args.batch,
            num_segments=args.segments,
            shuffle=phase == "train",
            transform=TransformConfig(
                crop_size=224,
                mirror=phase == "train",
                fix_crop=phase == "train",
                more_fix_crop=phase == "train",
                multi_scale=phase == "train",
            ),
        )
    return None


def _make_pipeline(args, dcfg, *, train, seed=0, rank=0, world=1):
    """--pipeline {python,native,raw,native-raw}: Python loader, C++
    libecodata loader, or raw-uint8 mode (host decodes, the card crops,
    mirrors and subtracts the mean in the step: K1, or the resize of
    ops/resize.py for multi-scale batches)."""
    import dataclasses

    from eco_tpu_torch.data import VideoPipeline
    from eco_tpu_torch.data.db import DBDataConfig, DBPipeline

    kind = getattr(args, "pipeline", "python") or "python"
    if isinstance(dcfg, DBDataConfig):
        if kind not in ("python", None):
            raise SystemExit(
                f"--pipeline {kind} does not apply to LMDB/LevelDB Data "
                "layers (host-decoded Datum records); drop the flag"
            )
        return DBPipeline(dcfg, train=train, seed=seed, rank=rank,
                          world=world)
    if kind in ("raw", "native-raw"):
        if not (dcfg.new_height and dcfg.new_width):
            # raw mode needs fixed decode size; the reference standard
            dcfg = dataclasses.replace(dcfg, new_height=256, new_width=340)
        # both raw planes honor multi_scale: the host samples (crop_h,
        # crop_w) per video and the card crops + resizes in the step
        dcfg = dataclasses.replace(dcfg, raw=True)
    if kind in ("native", "native-raw"):
        from eco_tpu_torch.data.native import NativeVideoPipeline

        return NativeVideoPipeline(
            dcfg, train=train, seed=seed, rank=rank, world=world
        )
    return VideoPipeline(
        dcfg, train=train, seed=seed, rank=rank, world=world
    )


def _rank_data(mesh, dcfg):
    """Under a mesh each rank decodes only its own videos, as the
    reference's MPI ranks do (cursor sharding, base_data_layer.cpp:42-45):
    ``batch / dp`` videos a batch from ``rank * batch / dp``, skipping the
    other data ranks' videos.  Every rank keeps the solver's seed, so all
    draw the same shuffle; ranks of one data index (``--tp``) read the same
    videos.  Returns (config, rank, world) for ``_make_pipeline``."""
    import dataclasses

    from eco_tpu_torch.parallel.mesh import DATA_AXIS, axis_rank, axis_size

    if mesh is None:
        return dcfg, 0, 1
    dp = axis_size(mesh, DATA_AXIS)
    return (dataclasses.replace(dcfg, batch_size=dcfg.batch_size // dp),
            axis_rank(mesh, DATA_AXIS), dp)


def _wrap_raw(args, prog, dcfg):
    if getattr(args, "pipeline", None) not in ("raw", "native-raw"):
        return prog
    from eco_tpu_torch.apps.serving import RawPreprocessProgram

    return RawPreprocessProgram(
        prog, crop=dcfg.transform.crop_size, mean=dcfg.transform.mean_values
    )


def _visible_devices(device: str) -> int:
    """Cards for ``cuda``; on the CPU each rank is a process on the host's
    cores, so as many ranks as cores."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else (
        os.cpu_count() or 1)


def _rank_main(rank: int, world: int, port: int, args):
    """One rank spawned by ``_parallel``: join the group, run the command."""
    from eco_tpu_torch.parallel.mesh import distributed_init

    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{rank}"
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    distributed_init(device=args.device, init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank)
    try:
        args.fn(args)
    finally:
        torch.distributed.destroy_process_group()


def _parallel(args, batch: int):
    """--dp/--tp: None for one device; else this rank's mesh, after joining
    the group (``torchrun``'s env) -- or, outside a group, spawn the ranks,
    each running the command, and return False."""
    from eco_tpu_torch.parallel.mesh import distributed_init, make_mesh

    tp = args.tp
    # --dp 0: every card (the CPU is one device)
    cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    dp = args.dp if args.dp != 0 else max(1, cards // max(tp, 1))
    if dp == 1 and tp == 1:
        return None
    if batch % dp:
        raise SystemExit(f"--dp {dp} must divide the batch size {batch}")
    if dp * tp > _visible_devices(args.device):
        raise SystemExit(f"--dp {dp} x --tp {tp} exceeds the "
                         f"{_visible_devices(args.device)} visible devices")
    dist = torch.distributed
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if torch.device(args.device).type == "cuda":
            args.device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
        distributed_init(device=args.device)
    if not dist.is_initialized():
        import torch.multiprocessing as mp

        from eco_tpu_torch.parallel.multiprocess import _free_port

        args.dp = dp
        mp.spawn(_rank_main, args=(dp * tp, _free_port(), args), nprocs=dp * tp)
        return False
    if dist.get_world_size() != dp * tp:
        raise SystemExit(f"--dp {dp} x --tp {tp} needs {dp * tp} ranks, the group has "
                         f"{dist.get_world_size()}")
    return make_mesh({"data": dp} if tp == 1 else {"data": dp, "model": tp})


def cmd_device_query(args):
    if not torch.cuda.is_available():
        print("device 0: cpu (cpu)")
        return
    for i in range(torch.cuda.device_count()):
        print(f"device {i}: {torch.cuda.get_device_name(i)} (cuda)")


def cmd_time(args):
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.runtime.profiler import format_layer_times, time_layers

    # `caffe time` builds the TRAIN-phase net and reports per-layer
    # forward AND backward ms (tools/caffe.cpp:318-357); --backward
    # reproduces that, the default stays the cheaper forward-only table.
    graph = _build_graph(args, with_loss=False)
    prog = Program(graph, train=args.backward,
                   compute_dtype=torch.bfloat16 if args.bf16 else None,
                   device=args.device)
    shape = graph.inputs.get("data")
    data = torch.from_numpy(
        np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ).to(prog.device)
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": data})
    rows = time_layers(prog, params, state, {"data": data}, iters=args.iters,
                       method=args.method, repeats=args.repeats,
                       backward=args.backward)
    print(format_layer_times(rows))
    return rows


def _digest_line(trainer, ts, mesh):
    """Under a mesh every rank logs the digest of the full params: they must
    be equal on every rank."""
    from eco_tpu_torch.parallel.multiprocess import params_digest
    from eco_tpu_torch.utils.logging import log, rank

    gather = getattr(trainer.dist, "gather_train_state", None)
    full = gather(ts) if gather is not None else ts
    log(f"rank {rank()}: params digest {params_digest(full.params)}", all_ranks=True)


def cmd_train(args):
    import dataclasses
    import itertools

    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import restore_weights
    from eco_tpu_torch.train.loop import Trainer, solver_config_from_prototxt
    from eco_tpu_torch.utils.logging import log

    cfg = solver_config_from_prototxt(open(args.solver).read())
    if args.net is None and args.zoo is None:
        from eco_tpu_torch.spec.prototxt import parse_prototxt

        net_file = parse_prototxt(open(args.solver).read()).get("net")
        args.net = os.path.join(os.path.dirname(args.solver), net_file)
    graph = _build_graph(args, with_loss=True)
    dcfg = _data_cfg_from_graph(graph, "train", args.list, args)
    if dcfg is None:
        raise SystemExit(
            "graph has no VideoData layer and no --list given; "
            "pass --list train.txt or use the python API"
        )
    mesh = _parallel(args, dcfg.batch_size)
    if mesh is False:
        return None  # the spawned ranks ran the command
    train_prog = Program(graph, train=True, device=args.device)
    test_prog = Program(graph, train=False, device=args.device)
    rank_cfg, rank, world = _rank_data(mesh, dcfg)
    pipe = _make_pipeline(args, rank_cfg, train=True, seed=cfg.random_seed,
                          rank=rank, world=world)
    train_prog = _wrap_raw(args, train_prog, dcfg)
    test_prog = _wrap_raw(args, test_prog, dcfg)

    def micro_batches():
        while True:
            ms = [pipe.next_batch() for _ in range(cfg.iter_size)]
            yield {k: np.stack([m[k] for m in ms]) for k in ms[0]}

    it = micro_batches()
    first = next(it)
    trainer = Trainer(
        train_prog, cfg, test_program=test_prog, mesh=mesh,
        log_fn=print if mesh is None else log,
        metrics_lag=0 if getattr(args, "no_overlap", False) else 1,
    )
    ts = trainer.init_state(
        {k: v[0] for k, v in first.items()}, seed=cfg.random_seed
    )
    if args.weights:
        params, state, loaded = restore_weights(args.weights, ts.params, ts.state)
        ts = dataclasses.replace(ts, params=params, state=state)
        print(f"Transferred {len(loaded)} layers from {args.weights}")
    if args.caffe_weights:
        from eco_tpu_torch.convert import import_caffe_weights

        params, state, report = import_caffe_weights(
            graph, ts.params, ts.state, args.caffe_weights
        )
        ts = dataclasses.replace(ts, params=params, state=state)
        print(f"Imported {len(report['loaded'])} caffemodel layers")
    if args.tp > 1:
        from eco_tpu_torch.parallel.tp import shard_tp_train_state

        ts = shard_tp_train_state(mesh, ts)

    feed = itertools.chain([first], it)
    if not getattr(args, "no_overlap", False):
        # the feed's copies run ahead of the consuming step on a side
        # stream (metrics_lag=1 keeps the host loop from blocking between
        # steps); --prefetch sets how many batches are in flight
        from eco_tpu_torch.data import prefetch_to_device

        feed = prefetch_to_device(feed, getattr(args, "prefetch", 1), device=args.device)
    try:
        ts = trainer.solve(ts, feed, resume_from=args.snapshot or None)
    finally:
        pipe.close()
    if mesh is not None:
        _digest_line(trainer, ts, mesh)
    return ts


def cmd_test(args):
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import load_model
    from eco_tpu_torch.train.loop import SolverConfig, Trainer
    from eco_tpu_torch.train.solver import init_train_state
    from eco_tpu_torch.utils.logging import log

    graph = _build_graph(args, with_loss=True)
    dcfg = _data_cfg_from_graph(graph, "test", args.list, args)
    if dcfg is None:
        raise SystemExit(
            "graph has no VideoData layer and no --list given; pass --list"
        )
    mesh = _parallel(args, dcfg.batch_size)
    if mesh is False:
        return None  # the spawned ranks ran the command
    prog = Program(graph, train=False, device=args.device)
    rank_cfg, rank, world = _rank_data(mesh, dcfg)
    pipe = _make_pipeline(args, rank_cfg, train=False, seed=0, rank=rank, world=world)
    prog = _wrap_raw(args, prog, dcfg)
    params, state = load_model(args.weights, device=args.device)
    ts = init_train_state(params, state)
    batches = (pipe.next_batch() for _ in range(args.iterations))
    if args.tp > 1:
        from eco_tpu_torch.parallel.tp import shard_tp_train_state

        ts = shard_tp_train_state(mesh, ts)
    trainer = Trainer(prog, SolverConfig(), test_program=prog, mesh=mesh,
                      log_fn=print if mesh is None else log)
    try:
        means = trainer.test(ts, batches)
    finally:
        pipe.close()
    return means


def _synthesize_sample_inputs(prog, graph):
    """Zero sample inputs for Program.init: declared deploy inputs plus
    shapes synthesized from any VideoData layer (train-style prototxts
    declare no inputs)."""
    sample = {
        k: torch.zeros(shape, dtype=torch.float32) for k, shape in graph.inputs.items()
    }
    for l in prog.graph.layers:
        if l.type.lower() != "videodata":
            continue
        t = dict(l.opt("transform", {}) or {})
        b = int(l.opt("batch_size", 1))
        crop = int(t.get("crop_size", 224))
        sl = int(l.opt("num_segments", 16)) * int(l.opt("new_length", 1))
        c = 3 if str(l.opt("modality", "RGB")).upper() == "RGB" else 2
        for top in l.tops:
            if top not in sample:
                sample[top] = (
                    torch.zeros((b,), dtype=torch.int32) if top == "label"
                    else torch.zeros((b, sl, crop, crop, c), dtype=torch.float32)
                )
    return sample


def cmd_convert(args):
    from eco_tpu_torch.convert import import_caffe_weights
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.spec.prototxt import graph_from_prototxt
    from eco_tpu_torch.train import save_model

    graph = graph_from_prototxt(open(args.net).read())
    prog = Program(graph, train=False, device=args.device)
    sample = _synthesize_sample_inputs(prog, graph)
    params, state = prog.init(torch.Generator().manual_seed(0), sample)
    params, state, report = import_caffe_weights(
        graph, params, state, args.caffemodel, bn_style=args.bn_style
    )
    save_model(args.output, params, state)
    print(
        f"Converted {len(report['loaded'])} layers "
        f"({len(report['skipped'])} skipped) -> {args.output}"
    )


def _default_parity_blob(prog) -> str:
    """Blob to diff against Caffe: prefer real activations over in-graph
    metric scalars (Accuracy/loss tops tell you almost nothing at 1e-3)."""
    metric_tops = {
        t for l in prog.exec_layers if l.type in ("accuracy",) for t in l.tops
    } | set(prog.loss_names)
    for name in reversed(prog.output_names):
        if name not in metric_tops:
            return name
    return prog.output_names[-1]


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def cmd_parity(args):
    """One-command real-weights parity gate (docs/REAL_WEIGHTS.md):
    convert -> coverage gate -> fixed-input logits (optionally diffed
    against a Caffe-produced reference) -> BN-fold self-check
    (gen_bn_inference.py:23-33 check() analogue) -> optional dataset eval.
    Emits ONE JSON verdict line and exits non-zero on any gate failure."""
    import json

    from eco_tpu_torch.convert import fold_bn, import_caffe_weights
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.spec.prototxt import graph_from_prototxt

    graph = graph_from_prototxt(open(args.net).read())
    prog = Program(graph, train=False, device=args.device)
    sample = _synthesize_sample_inputs(prog, graph)
    params, state = prog.init(torch.Generator().manual_seed(0), sample)
    expected = sorted(set(params) | set(state))
    params, state, report = import_caffe_weights(
        graph, params, state, args.caffemodel, bn_style=args.bn_style
    )
    gates: dict = {}
    loaded = set(report["loaded"])
    missing = [n for n in expected if n not in loaded]
    gates["coverage"] = {
        "loaded": len(loaded),
        "skipped": sorted(set(report["skipped"])),
        "unloaded_model_layers": missing,
        "pass": not report["skipped"] and not missing,
    }

    # fixed-input forward: the reference's seeded input, which the Caffe
    # side can reproduce
    rng = np.random.default_rng(args.seed)
    fixed = {
        k: (torch.from_numpy(rng.integers(0, 2, tuple(v.shape)).astype(np.int32))
            if v.dtype == torch.int32
            else torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 10.0)
                                  .astype(np.float32)))
        for k, v in sample.items()
    }
    blob = args.blob or _default_parity_blob(prog)
    with torch.no_grad():
        outs, _ = prog.apply(params, state, fixed, capture=[blob])
    logits = _np(outs[blob])

    if args.ref_logits:
        with np.load(args.ref_logits) as z:
            ref = z["logits"].astype(np.float32)
        diff = float(np.max(np.abs(logits - ref)))
        gates["fixed_input_logits"] = {
            "max_abs_diff": diff, "tol": args.tol, "pass": diff <= args.tol,
        }
    else:
        dump = os.path.splitext(args.output)[0] + ".logits.npz" if args.output \
            else "parity.logits.npz"
        np.savez(dump, logits=logits, seed=np.int64(args.seed), blob=blob)
        gates["fixed_input_logits"] = {
            "dumped": dump, "note": "no --ref-logits given; run the Caffe "
            "side on the same seeded input and re-run with --ref-logits",
            "pass": True,
        }

    # BN-fold self-consistency (always runnable, no reference needed)
    fg, fp, fs = fold_bn(graph, params, state)
    fprog = Program(fg, train=False, device=args.device)
    with torch.no_grad():
        fouts, _ = fprog.apply(fp, fs, fixed, capture=[blob])
    fdiff = float(np.max(np.abs(_np(fouts[blob]) - logits)))
    gates["bn_fold_consistency"] = {
        "max_abs_diff": fdiff, "tol": args.tol, "pass": fdiff <= args.tol,
    }

    qmodel = None
    if args.int8:
        # int8 PTQ gate: quantize on the fixed input (plus dataset batches
        # below when --list is given) and require argmax agreement
        from eco_tpu_torch.convert.quantize import quantize_for_serving

        with torch.no_grad():
            qprog, qpms, qst, qreport = quantize_for_serving(
                prog, params, state, [fixed]
            )
            qouts, _ = qprog.apply(qpms, qst, fixed, capture=[blob])
        ql = _np(qouts[blob])

        def _cls(a):  # per-row argmax; scalars/vectors become one row
            a = a.reshape(a.shape[0], -1) if a.ndim >= 2 else a.reshape(1, -1)
            return a.argmax(-1)

        agree = float((_cls(logits) == _cls(ql)).mean())
        gates["int8_quantization"] = {
            "layers": len(qreport["quantized"]),
            "max_abs_diff": float(np.max(np.abs(ql - logits))),
            "argmax_agreement": agree,
            "min_agreement": args.int8_agree,
            "pass": agree >= args.int8_agree,
        }
        qmodel = (qprog, qpms, qst)

    if args.list:
        from eco_tpu_torch.train.loop import SolverConfig, Trainer
        from eco_tpu_torch.train.solver import init_train_state

        dcfg = _data_cfg_from_graph(graph, "test", args.list, args)
        if dcfg is None:
            raise SystemExit("--list given but graph has no VideoData layer")
        pipe = _make_pipeline(args, dcfg, train=False, seed=0)
        eprog = _wrap_raw(args, prog, dcfg)  # raw plane: crop/mean on the card
        trainer = Trainer(eprog, SolverConfig(), test_program=eprog)
        means = trainer.test(
            init_train_state(params, state),
            (pipe.next_batch() for _ in range(args.iterations)),
        )
        pipe.close()
        g = {"metrics": {k: float(v) for k, v in means.items()}}
        if args.expect_top1 is not None:
            top1 = next(
                (float(v) for k, v in means.items() if "top1" in k or k == "accuracy"),
                None,
            )
            g["expect_top1"] = args.expect_top1
            g["pass"] = (
                top1 is not None and abs(top1 - args.expect_top1) <= args.top1_tol
            )
        else:
            g["pass"] = True
        gates["dataset_eval"] = g

        if qmodel is not None:
            # quantized dataset eval: top-1 within --int8-top1-drop of f32
            qprog, qpms, qst = qmodel
            pipe = _make_pipeline(args, dcfg, train=False, seed=0)
            qtrainer = Trainer(qprog, SolverConfig(), test_program=qprog)
            qmeans = qtrainer.test(
                init_train_state(qpms, qst),
                (pipe.next_batch() for _ in range(args.iterations)),
            )
            pipe.close()

            def _top1(ms):
                return next(
                    (float(v) for k, v in ms.items()
                     if "top1" in k or k == "accuracy"), None,
                )
            t_f, t_q = _top1(means), _top1(qmeans)
            gq = {"metrics": {k: float(v) for k, v in qmeans.items()}}
            if t_f is not None and t_q is not None:
                gq["top1_drop"] = t_f - t_q
                gq["max_drop"] = args.int8_top1_drop
                gq["pass"] = (t_f - t_q) <= args.int8_top1_drop
            else:
                gq["pass"] = True
            gates["int8_dataset_eval"] = gq

    verdict = {
        "net": args.net,
        "caffemodel": args.caffemodel,
        "blob": blob,
        "gates": gates,
        "pass": all(g.get("pass", False) for g in gates.values()),
    }
    line = json.dumps(verdict)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    if not verdict["pass"]:
        raise SystemExit(2)
    return verdict


def cmd_fold(args):
    from eco_tpu_torch.convert import fold_bn
    from eco_tpu_torch.spec.graph import graph_to_json
    from eco_tpu_torch.train import load_model, save_model

    graph = _build_graph(args, with_loss=False)
    params, state = load_model(args.weights, device=args.device)
    fg, fp, fs = fold_bn(graph, params, state)
    save_model(args.output, fp, fs)
    # The folded weights only make sense against the folded graph (BN layers
    # removed, conv biases injected) -- persist it alongside, loadable via
    # --net <...>.graph.json (gen_bn_inference.py emits *_inference.prototxt).
    graph_path = os.path.splitext(args.output)[0] + ".graph.json"
    with open(graph_path, "w") as f:
        f.write(graph_to_json(fg))
    print(f"Folded model -> {args.output} + {graph_path} "
          f"({len(fg.layers)} layers)")


def cmd_quantize(args):
    """int8 post-training quantization: fold BN, calibrate on real batches,
    rewrite conv/fc to int8 twins; persists weights + the quantized graph
    (no reference counterpart -- Caffe serves f32)."""
    from eco_tpu_torch.convert.quantize import quantize_for_serving
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.spec.graph import graph_to_json
    from eco_tpu_torch.train import load_model, save_model

    graph = _build_graph(args, with_loss=False)
    prog = Program(graph, train=False, device=args.device)
    params, state = load_model(args.weights, device=args.device)

    batches = []
    dcfg = _data_cfg_from_graph(graph, "test", args.list, args)
    if args.list and dcfg is not None:
        pipe = _make_pipeline(args, dcfg, train=False, seed=0)
        for _ in range(args.calib_batches):
            b = pipe.next_batch()
            # full batch (data AND label): phase-TEST graphs keep their
            # loss/accuracy tops, which consume the label blob
            batches.append({k: torch.as_tensor(v).to(prog.device) for k, v in b.items()})
        pipe.close()
    else:
        # no calibration data: random-normal at ImageNet-ish post-mean scale.
        # Scales will be loose; pass --list for production calibration.
        print("WARNING: no --list given; calibrating on random data")
        if not graph.inputs:
            raise SystemExit("graph declares no inputs; pass --list")
        gen = torch.Generator().manual_seed(0)
        batches.append({
            name: (60.0 * torch.randn(shape, generator=gen)).to(prog.device)
            for name, shape in graph.inputs.items()
        })

    with torch.no_grad():
        qprog, qp, qs, report = quantize_for_serving(
            prog, params, state, batches, chain=not args.no_chain
        )
    save_model(args.output, qp, qs)
    graph_path = os.path.splitext(args.output)[0] + ".graph.json"
    with open(graph_path, "w") as f:
        f.write(graph_to_json(qprog.graph))
    print(
        f"Quantized {len(report['quantized'])} layers "
        f"({len(report.get('chained', []))} int8-chained) -> {args.output} "
        f"+ {graph_path} (run with --net {graph_path})"
    )


def cmd_online(args):
    """Streaming recognition -- the webcam demo
    (scripts/online_recognition/online_recognition.py): frames from a
    directory (--frames) or a live camera (--camera N), optional cv2
    display window with the label overlay (--display, 'q' quits)."""
    from eco_tpu_torch.apps import OnlineRecognizer
    from eco_tpu_torch.apps.online import _FrameDirCapture, run_capture_loop
    from eco_tpu_torch.runtime import Program

    if (args.frames is None) == (args.camera is None):
        raise SystemExit("pass exactly one of --frames DIR or --camera N")
    graph = _build_graph(args, with_loss=False)
    prog = Program(graph, train=False, compute_dtype=torch.bfloat16, device=args.device)
    params, state = prog.init(torch.Generator().manual_seed(0), dict(graph.inputs))
    if args.weights:
        from eco_tpu_torch.train import restore_weights

        params, state, _ = restore_weights(args.weights, params, state)
    labels = None
    if args.classes:
        from eco_tpu_torch.tools.datasets import load_class_index

        labels = load_class_index(args.classes)
    rec = OnlineRecognizer(
        prog, params, state, num_segments=args.segments, plane=args.plane,
    )
    if args.camera is not None:
        import cv2

        cap = cv2.VideoCapture(args.camera)
        if not cap.isOpened():
            raise SystemExit(f"camera {args.camera} could not be opened")
    else:
        cap = _FrameDirCapture(args.frames)
    try:
        run_capture_loop(
            rec, cap, class_names=labels, display=args.display,
            on_prediction=lambda i, idx, label: print(
                f"frame {i}: prediction = {label}"
            ),
        )
    finally:
        cap.release()


def cmd_convert_imageset(args):
    """Pack an image list into HDF5 (tools/convert_imageset.cpp parity;
    LMDB/LevelDB -> HDF5 is the documented backend substitution)."""
    from eco_tpu_torch.tools.datasets import convert_imageset

    n = convert_imageset(
        args.root_folder, args.list_file, args.output,
        gray=args.gray, shuffle=args.shuffle,
        resize_height=args.resize_height, resize_width=args.resize_width,
    )
    print(f"wrote {n} records to {args.output}")
    return 0


def cmd_extract(args):
    """Dump intermediate activations (tools/extract_features.cpp parity)."""
    from eco_tpu_torch.runtime import Program

    graph = _build_graph(args, with_loss=False)
    prog = Program(graph, train=False, device=args.device)
    dcfg = _data_cfg_from_graph(graph, "test", args.list, args)
    if dcfg is None:
        raise SystemExit("pass --list with the videos to extract from")
    if getattr(args, "pipeline", None) in ("raw", "native-raw"):
        raise SystemExit("--pipeline raw is not supported for extract; "
                         "use python or native")
    pipe = _make_pipeline(args, dcfg, train=False, seed=0)
    batch = pipe.next_batch()
    pipe.close()
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": batch["data"]})
    if args.weights:
        from eco_tpu_torch.train import restore_weights

        params, state, _ = restore_weights(args.weights, params, state)
    blobs = [b.strip() for b in args.blobs.split(",")]
    with torch.no_grad():
        outs, _ = prog.apply(params, state, {"data": batch["data"]}, capture=blobs)
    arrays = {b: outs[b].cpu().numpy() for b in blobs}
    np.savez(args.output, **arrays)
    print(f"wrote {args.output}: " + ", ".join(
        f"{b}{tuple(arrays[b].shape)}" for b in blobs
    ))


def cmd_export(args):
    """Write a trained model back to .caffemodel (Net::ToProto parity) so
    fine-tuned weights can be deployed on a Caffe stack."""
    from eco_tpu_torch.convert import params_to_jax
    from eco_tpu_torch.convert.write import export_caffe_weights
    from eco_tpu_torch.train import load_model

    graph = _build_graph(args, with_loss=False)
    params, state = load_model(args.weights, device=args.device)
    # the writer takes the reference's weight layout
    params, state = params_to_jax(graph, params, state)
    exported = export_caffe_weights(graph, params, state, args.output)
    print(f"Exported {len(exported)} layers -> {args.output}")


def _read_class_names(path):
    """Class-name list, one per line; blank lines dropped (a trailing
    newline must not become an empty class)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def cmd_aot(args):
    """Export an inference program to a serving artifact (``torch.export``,
    ``.pt2``): the deploy.prototxt + .caffemodel pair in one file, with the
    weights baked in, loadable by any PyTorch process with no eco_tpu_torch
    and no model code (``convert/export.py``).  The trace runs on the CPU,
    so the artifact holds the plain versions of K1 and K3; loading, the
    optimisation passes and the ``--int8`` calibration run on ``--device``."""
    import json

    from eco_tpu_torch.convert import (
        export_serving, optimize_for_inference, save_serving_artifact,
    )
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import load_model

    graph = _build_graph(args, with_loss=False)
    params, state = load_model(args.weights, device=args.device)
    if args.optimize:
        graph, params, state = optimize_for_inference(graph, params, state)
    prog = Program(graph, train=False, compute_dtype=torch.bfloat16 if args.bf16 else None,
                   device=args.device)
    if args.int8:
        # post-training int8 quantization baked into the artifact (with
        # --uint8 the int8 input plane joins the baked preprocess)
        from eco_tpu_torch.convert.quantize import quantize_for_serving

        batches = []
        dcfg = _data_cfg_from_graph(graph, "test", args.list, args)
        if args.list and dcfg is not None:
            pipe = _make_pipeline(args, dcfg, train=False, seed=0)
            for _ in range(args.calib_batches):
                b = pipe.next_batch()
                batches.append({k: torch.as_tensor(v).to(prog.device) for k, v in b.items()
                                 if not graph.inputs or k in graph.inputs})
            pipe.close()
        else:
            print("WARNING: no --list given; calibrating on random data")
            if not graph.inputs:
                raise SystemExit("graph declares no inputs; pass --list")
            gen = torch.Generator().manual_seed(0)
            batches.append({name: (60.0 * torch.randn(shape, generator=gen)).to(prog.device)
                            for name, shape in graph.inputs.items()})
        with torch.no_grad():
            prog, params, state, qreport = quantize_for_serving(
                prog, params, state, batches,
                compute_dtype=torch.bfloat16 if args.bf16 else None)
        graph = prog.graph
        print(f"Quantized {len(qreport['quantized'])} layers "
              f"({len(qreport['chained'])} int8-chained) for export")
    # spatial size comes from the graph's declared input, not a flag
    shape = graph.inputs.get("data")
    crop = shape[2] if shape is not None and len(shape) == 5 else 224
    segments = shape[1] if shape is not None and len(shape) == 5 else args.segments
    # the preprocess mean baked into --uint8 artifacts (and the contract the
    # sidecar declares for float inputs): --mean, else the graph's own
    # transform_param mean_value, else the BGR ImageNet default
    if args.mean:
        mean_bgr = [float(v) for v in args.mean.split(",")]
    else:
        dcfg = _data_cfg_from_graph(graph, "test")
        mean_bgr = (list(dcfg.transform.mean_values) if dcfg is not None
                    else [104.0, 117.0, 123.0])
    exported = export_serving(
        prog, params, state, batch=args.batch, segments=segments, crop=crop,
        dynamic_batch=args.dynamic_batch, uint8=args.uint8,
        frame_hw=(args.frame_h, args.frame_w), mean=tuple(mean_bgr),
    )
    nbytes = save_serving_artifact(exported, args.output)
    # deploy contract sidecar: the destination has no eco_tpu_torch to ask
    in_specs = [n.meta["val"] for n in exported.graph.nodes
                if n.op == "placeholder" and n.name in exported.graph_signature.user_inputs]
    meta = {
        "source": args.zoo or args.net,
        "inputs": (["frames_u8 (N,S,H,W,3) BGR", "h_off (N,)", "w_off (N,)", "mirror (N,)"]
                   if args.uint8 else ["clips (N,S,crop,crop,3) BGR, mean-subtracted"]),
        "in_avals": [{"shape": [str(d) for d in v.shape], "dtype": str(v.dtype)}
                     for v in in_specs],
        "output": "class probabilities (N, num_classes)",
        "mean_bgr": mean_bgr,
        "load": "torch.export.load(path), torch.export.passes.move_to_device_pass"
                "(ep, 'cuda' or 'cpu'), then .module()",
        "bf16": args.bf16,
        "int8": bool(args.int8),
        "classes": _read_class_names(args.classes) if args.classes else None,
    }
    with open(args.output + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    shapes = ", ".join(str(tuple(v.shape)) for v in in_specs)
    print(f"wrote {args.output}: {nbytes/1e6:.1f} MB, in=({shapes}); "
          f"contract -> {args.output}.json")


def cmd_upgrade(args):
    """V1-text -> V2-text prototxt upgrade (upgrade_net_proto_text.cpp).

    Weight-file (binary NetParameter) upgrades are covered by
    ``eco convert`` instead, which reads V0/V1/V2 wire format directly
    (upgrade_net_proto_binary.cpp has no separate role on this stack).
    """
    from eco_tpu_torch.spec.prototxt import (
        format_prototxt, parse_prototxt, upgrade_v1_net,
    )

    with open(args.input) as f:
        net = parse_prototxt(f.read())
    if "layers" not in net:
        print(f"File already in latest proto format: {args.input}")
        upgraded = net
    else:
        upgraded = upgrade_v1_net(net)
    with open(args.output, "w") as f:
        f.write(format_prototxt(upgraded))
    print(f"Wrote upgraded NetParameter text proto to {args.output}")


def cmd_plot(args):
    """Parse a Trainer log into the reference's train/test tables and
    render the training curves (tools/extra parse_log.sh +
    plot_training_log.py.example parity)."""
    from eco_tpu_torch.tools.logparse import parse_log, plot_curves, write_tables

    with open(args.log) as f:
        parsed = parse_log(f.read())
    if not parsed.train["iters"] and not parsed.test["iters"]:
        raise SystemExit(
            f"{args.log}: no Trainer 'Iteration N, loss = ...' or "
            "'Test: ...' lines found"
        )
    tr, te = write_tables(args.log, parsed)
    print(f"wrote {tr} ({len(parsed.train['iters'])} rows), "
          f"{te} ({len(parsed.test['iters'])} rows)")
    if args.output:
        fields = tuple(args.fields.split(",")) if args.fields else (
            "loss", "lr", "accuracy", "accuracy_top5")
        plot_curves(parsed, args.output, x_axis=args.x_axis, fields=fields)
        print(f"wrote {args.output}")


def cmd_draw(args):
    from eco_tpu_torch.tools.draw import to_dot

    graph = _build_graph(args, with_loss=False)
    dot = to_dot(graph)
    if args.output:
        open(args.output, "w").write(dot)
        print(f"wrote {args.output}")
    else:
        print(dot)


def main(argv=None):
    p = argparse.ArgumentParser(prog="eco")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")

    def common(sp):
        sp.add_argument("--zoo")
        sp.add_argument("--net")
        sp.add_argument("--batch", type=int, default=4)
        sp.add_argument("--segments", type=int, default=16)
        sp.add_argument("--list", default=None)
        sp.add_argument(
            "--pipeline", default="python",
            choices=["python", "native", "raw", "native-raw"],
            help="data plane: python loader, C++ libecodata, or raw uint8 "
                 "with the crop/mirror/mean on the card (raw = python "
                 "decode, native-raw = C++ decode)",
        )
        device(sp)

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--solver", required=True)
    sp.add_argument("--weights", default=None)
    sp.add_argument("--caffe-weights", default=None)
    sp.add_argument("--snapshot", default=None)
    sp.add_argument("--dp", type=int, default=1,
                    help="data-parallel over N devices (0 = all devices), one rank a "
                         "device, SyncBN; spawned here, or under torchrun")
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel over N devices (channel-sharded weights)")
    sp.add_argument("--no-overlap", action="store_true",
                    help="disable the async feed pipeline (device batch "
                         "prefetch + one-step-lagged metric reads); loss "
                         "display and divergence detection become exact "
                         "per-step at the cost of serializing host and card")
    sp.add_argument("--prefetch", type=int, default=1,
                    help="device-feed queue depth (batches in flight ahead "
                         "of the step)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("test")
    common(sp)
    sp.add_argument("--weights", required=True)
    sp.add_argument("--iterations", type=int, default=50)
    sp.add_argument("--dp", type=int, default=1,
                    help="data-parallel eval over N devices (0 = all devices)")
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel eval over N devices")
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("time")
    common(sp)
    sp.add_argument("--iters", type=int, default=10)
    sp.add_argument("--repeats", type=int, default=1,
                    help="time each layer in N blocks and keep the least")
    sp.add_argument("--bf16", action="store_true")
    sp.add_argument("--method", default="auto",
                    choices=["auto", "host", "device_loop"],
                    help="auto / device_loop = CUDA events around a block of "
                         "calls on the card; host = the host's clock with a "
                         "synchronisation after every call")
    sp.add_argument("--backward", action="store_true",
                    help="also time each layer's backward (caffe time parity)")
    sp.set_defaults(fn=cmd_time)

    sp = sub.add_parser("device-query")
    sp.set_defaults(fn=cmd_device_query)

    sp = sub.add_parser("convert")
    sp.add_argument("--caffemodel", required=True)
    sp.add_argument("--net", required=True)
    sp.add_argument("--bn-style", default="var", choices=["var", "inv_std"])
    sp.add_argument("-o", "--output", required=True)
    device(sp)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser(
        "parity",
        help="run the docs/REAL_WEIGHTS.md gates against a caffemodel; "
             "one JSON verdict, non-zero exit on failure",
    )
    sp.add_argument("--caffemodel", required=True)
    sp.add_argument("--net", required=True)
    sp.add_argument("--bn-style", default="var", choices=["var", "inv_std"])
    sp.add_argument("--blob", default=None,
                    help="output blob to compare (default: last output)")
    sp.add_argument("--seed", type=int, default=12345,
                    help="fixed-input seed (record for the Caffe side)")
    sp.add_argument("--tol", type=float, default=1e-3,
                    help="max abs logit diff (1e-3 f32; 2e-2 bf16)")
    sp.add_argument("--ref-logits", default=None,
                    help=".npz with key 'logits' from the Caffe run")
    sp.add_argument("--list", default=None,
                    help="video list for the dataset-eval gate")
    sp.add_argument("--iterations", type=int, default=10)
    # deploy-style nets have no VideoData layer; the dataset gate then
    # builds its pipeline from these (same defaults as the zoo path)
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--segments", type=int, default=16)
    sp.add_argument("--pipeline", default="python",
                    choices=["python", "native", "raw", "native-raw"])
    sp.add_argument("--expect-top1", type=float, default=None)
    sp.add_argument("--top1-tol", type=float, default=0.005)
    sp.add_argument("--int8", action="store_true",
                    help="also gate int8 PTQ: fixed-input argmax agreement "
                         "(+ quantized dataset eval when --list is given)")
    sp.add_argument("--int8-agree", type=float, default=0.99,
                    help="min fixed-input argmax agreement for --int8")
    sp.add_argument("--int8-top1-drop", type=float, default=0.02,
                    help="max top-1 drop vs f32 for the int8 dataset gate")
    sp.add_argument("-o", "--output", default=None)
    device(sp)
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("fold")
    common(sp)
    sp.add_argument("--weights", required=True)
    sp.add_argument("-o", "--output", required=True)
    sp.set_defaults(fn=cmd_fold)

    sp = sub.add_parser("quantize")  # int8 PTQ for serving
    common(sp)
    sp.add_argument("--weights", required=True)
    sp.add_argument("--calib-batches", type=int, default=4,
                    help="calibration batches drawn from --list "
                         "(random data with a warning otherwise)")
    sp.add_argument("--no-chain", action="store_true",
                    help="keep per-layer float edges (skip int8 chain "
                         "fusion between adjacent quantized layers)")
    sp.add_argument("-o", "--output", required=True)
    sp.set_defaults(fn=cmd_quantize)

    sp = sub.add_parser("export")  # model.npz -> .caffemodel
    common(sp)
    sp.add_argument("--weights", required=True)
    sp.add_argument("-o", "--output", required=True)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser(
        "aot",  # torch.export serving artifact (deploy prototxt+caffemodel analogue)
        help="export an inference graph + weights to one torch.export serving "
             "artifact (.pt2); runs anywhere with torch alone",
    )
    common(sp)
    sp.add_argument("--weights", required=True)
    sp.add_argument("--bf16", action="store_true", help="export the model in bfloat16")
    sp.add_argument("--no-optimize", dest="optimize", action="store_false",
                    help="skip sibling-1x1 merge + BN fold before export")
    sp.add_argument("--dynamic-batch", action="store_true",
                    help="symbolic batch dim: one artifact, any batch size")
    sp.add_argument("--uint8", action="store_true",
                    help="bake the uint8 crop/mean preprocess into the artifact "
                         "(raw resized frames + offsets in)")
    sp.add_argument("--int8", action="store_true",
                    help="post-training int8 quantize before export (calibrates on "
                         "--list batches, else random); with --uint8 the input "
                         "plane is int8 too")
    sp.add_argument("--calib-batches", type=int, default=4,
                    help="--int8 calibration batch count from --list")
    sp.add_argument("--frame-h", type=int, default=256)
    sp.add_argument("--frame-w", type=int, default=340)
    sp.add_argument("--crop", type=int, default=None,
                    help="--zoo input crop size (default: the zoo model's 224); "
                         "--net graphs declare their own input shape")
    sp.add_argument("--mean", default=None,
                    help="comma BGR mean to bake into --uint8 preprocess / record in "
                         "the sidecar (default: the graph's transform_param "
                         "mean_value, else 104,117,123)")
    sp.add_argument("--classes", default=None,
                    help="class-name list file to embed in the contract sidecar "
                         "(<output>.json)")
    sp.add_argument("-o", "--output", required=True)
    sp.set_defaults(fn=cmd_aot)

    sp = sub.add_parser(
        "plot",
        help="parse a training log into <log>.train/<log>.test tables and "
             "plot loss/lr/accuracy curves (tools/extra parity)",
    )
    sp.add_argument("log", help="Trainer log file (eco train output)")
    sp.add_argument("-o", "--output", default=None,
                    help="curve image (png/svg/pdf); tables alone if unset")
    sp.add_argument("--x-axis", choices=["iters", "seconds"],
                    default="iters")
    sp.add_argument("--fields", default=None,
                    help="comma list of curves (default loss,lr,accuracy"
                         ",accuracy_top5)")
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser("draw")
    common(sp)
    sp.add_argument("-o", "--output", default=None)
    sp.set_defaults(fn=cmd_draw)

    sp = sub.add_parser("online")
    common(sp)
    sp.add_argument("--frames", default=None, help="directory of frames")
    sp.add_argument("--camera", type=int, default=None,
                    help="live capture from cv2.VideoCapture(N) "
                         "(the reference webcam demo)")
    sp.add_argument("--display", action="store_true",
                    help="show the cv2 window with the label overlay "
                         "('q' quits); requires a GUI-capable OpenCV")
    sp.add_argument("--plane", choices=("uint8", "f32"), default="uint8",
                    help="uint8 (default): ship raw crops, mean/bf16 "
                         "on the card; f32: classic host-side preprocessing")
    sp.add_argument("--weights", default=None)
    sp.add_argument("--classes", default=None, help="class-name list file")
    sp.set_defaults(fn=cmd_online)

    sp = sub.add_parser(
        "upgrade",  # tools/upgrade_net_proto_text.cpp parity
        help="upgrade a V1 prototxt (layers{type: ENUM}) to V2 text format",
    )
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_upgrade)

    sp = sub.add_parser(
        "convert-imageset",  # tools/convert_imageset.cpp parity (HDF5 target)
        help="pack an image list into an HDF5 record store",
    )
    sp.add_argument("root_folder")
    sp.add_argument("list_file", help="lines of 'relative/path.jpg label'")
    sp.add_argument("output", help="output .h5 (data: NCHW uint8, label)")
    sp.add_argument("--gray", action="store_true")
    sp.add_argument("--shuffle", action="store_true")
    sp.add_argument("--resize-height", type=int, default=0)
    sp.add_argument("--resize-width", type=int, default=0)
    sp.set_defaults(fn=cmd_convert_imageset)

    sp = sub.add_parser("extract")  # extract_features parity
    common(sp)
    sp.add_argument("--weights", default=None)
    sp.add_argument("--blobs", required=True, help="comma-separated blob names")
    sp.add_argument("-o", "--output", required=True, help="output .npz")
    sp.set_defaults(fn=cmd_extract)

    args, rest = p.parse_known_args(argv)
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
