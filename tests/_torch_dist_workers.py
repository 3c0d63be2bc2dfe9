"""Rank bodies for the multi-process tests of ``eco_tpu_torch.parallel`` and
the mesh serving artifact.

Spawned ranks import this module and ``eco_tpu_torch`` only, never JAX or
``eco_tpu``: the tests compute the reference's numbers in the parent process
and hand the ranks numpy inputs.  ``run(name, payload)`` starts ``world``
ranks over gloo on the CPU (``torch.multiprocessing``, spawn, a free
localhost port), each calls ``name(rank, world, payload)``, and returns the
ranks' results in rank order; it kills the ranks at ``timeout``.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, name, payload, outdir):
    torch.set_num_threads(2)
    from eco_tpu_torch.parallel.mesh import distributed_init

    distributed_init(device="cpu", init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank)
    try:
        torch.save(globals()[name](rank, world, payload), os.path.join(outdir, f"{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run(name: str, payload, *, world: int = 2, timeout: float = 120.0) -> list:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as outdir:
        ctx = mp.start_processes(_entry, args=(world, free_port(), name, payload, outdir),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks of {name} still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(outdir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


# --------------------------------------------------------------------------
# graphs (the port's NetBuilder, the same code as tests/test_parallel.py)
# --------------------------------------------------------------------------


def small_video_graph(with_loss):
    from eco_tpu_torch.spec.netspec import NetBuilder

    b = NetBuilder("mini_eco")
    x = b.input("data", (8, 4, 16, 16, 3))
    if with_loss:
        b.input("label", (8,))
    x = b.layer("fold", "fold_segments", x)
    x = b.conv_bn_relu("conv1", x, 8, k=3, s=2, p=1)
    x = b.layer("unfold", "unfold_segments", x, num_segments=4)
    x = b.layer(
        "c3d", "convolution", x, num_output=16, kernel_size=(3, 3, 3),
        stride=(2, 2, 2), pad=(1, 1, 1), weight_filler={"type": "xavier"},
    )
    x = b.bn("c3d_bn", x)
    x = b.layer("gap", "global_avg_pool", x)
    y = b.fc("fc", x, 5)
    if with_loss:
        b.layer("loss", "softmaxwithloss", (y, "label"))
    else:
        b.layer("probs", "softmax", y)
    return b.build()


def gather_section_graph(with_loss):
    """fc_in -> Gather -> fc_mid -> BN -> Scatter -> fc_out: a section that
    runs on the whole batch under a mesh (the BN mixes the batch, so the
    Gather's gradient needs its reduce-scatter)."""
    from eco_tpu_torch.spec.netspec import NetBuilder

    b = NetBuilder("gsec")
    x = b.input("data", (8, 6))
    if with_loss:
        b.input("label", (8,))
    x = b.fc("fc_in", x, 8)
    x = b.layer("gather1", "gather", x)
    x = b.fc("fc_mid", x, 8)
    x = b.bn("mid_bn", x)
    x = b.layer("scatter1", "scatter", x)
    y = b.fc("fc_out", x, 4)
    if with_loss:
        b.layer("loss", "softmaxwithloss", (y, "label"))
    else:
        b.layer("probs", "softmax", y)
    return b.build()


MINI_SOLVER = dict(base_lr=0.1, lr_policy="fixed", iter_size=2, clip_gradients=10.0,
                   solver_type="nesterov")


def tensors(tree):
    return {ln: {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
            for ln, lp in tree.items()}


def arrays(tree):
    return {ln: {k: v.detach().cpu().numpy() for k, v in lp.items()} for ln, lp in tree.items()}


# --------------------------------------------------------------------------
# rank bodies
# --------------------------------------------------------------------------


def _step(make_step, prog, cfg, mesh, params, state, batch, *, tp=False, **kw):
    from eco_tpu_torch.parallel.tp import shard_tp_train_state
    from eco_tpu_torch.train.solver import init_train_state

    ts = init_train_state(tensors(params), tensors(state))
    if tp:
        ts = shard_tp_train_state(mesh, ts)
    step = make_step(prog, cfg, mesh, **kw)
    ts, m = step(ts, batch)
    if tp:
        shards = {"conv1_w": tuple(ts.params["conv1"]["w"].shape),
                  "conv1_w_history": tuple(ts.history["conv1"]["w"].shape)}
        ts = step.dist.gather_train_state(ts)
        return {"params": arrays(ts.params), "state": arrays(ts.state),
                "loss": float(m["loss"]), "shards": shards}
    return {"params": arrays(ts.params), "state": arrays(ts.state), "loss": float(m["loss"])}


def parallel_suite(rank, world, p):
    """Every 2-rank check of tests/test_torch_parallel.py in one spawn."""
    import torch.distributed as dist

    from eco_tpu_torch import ops
    from eco_tpu_torch.models import build_eco_lite
    from eco_tpu_torch.parallel import (
        make_mesh, make_segment_sharded_infer_fn, make_segment_sharded_train_step,
        make_sharded_infer_fn, make_sharded_train_step, make_tp_infer_fn,
        make_tp_train_step, mesh_shape, shard_batch, shard_tp_tree,
    )
    from eco_tpu_torch.parallel.multiprocess import params_digest
    from eco_tpu_torch.parallel.tp import shard_tp_train_state
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state

    out = {}
    # mesh construction and its error
    mesh = make_mesh()
    try:
        make_mesh({"data": 3})
        bad = None
    except ValueError as e:
        bad = str(e)
    out["mesh"] = {"default": mesh_shape(mesh),
                   "segment": mesh_shape(make_mesh({"data": 1, "segment": -1})),
                   "bad": bad}

    # SyncBN on this rank's half, by process group and by mesh dimension,
    # with the gradient of a seeded cotangent; and a group of one rank
    x = torch.from_numpy(p["bn_x"]).chunk(world)[rank].clone().requires_grad_()
    gamma = torch.from_numpy(p["bn_gamma"]).requires_grad_()
    args = (gamma, torch.from_numpy(p["bn_beta"]), torch.zeros(4), torch.ones(4))
    y, nm, nv = ops.bn_train(x, *args, axis_name=dist.group.WORLD)
    cot = torch.from_numpy(p["bn_cot"]).chunk(world)[rank]
    gx, gg = torch.autograd.grad((y * cot).sum(), (x, gamma))
    y2 = ops.bn_train(x, *args, axis_name=mesh["data"])[0]
    ones = [dist.new_group([r]) for r in range(world)]
    alone = ops.bn_train(x, *args, axis_name=ones[rank])
    plain = ops.bn_train(x, *args)
    out["syncbn"] = {
        "y": y.detach().numpy(), "mean": nm.numpy(), "var": nv.numpy(),
        "gx": gx.numpy(), "ggamma": gg.numpy(),
        "mesh_dim_equal": bool(torch.equal(y, y2)),
        "world1_equal": all(torch.equal(a, b) for a, b in zip(alone, plain)),
    }

    mini_train = Program(small_video_graph(True), train=True, device="cpu")
    mini_test = Program(small_video_graph(False), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    cfg = SolverConfig(**MINI_SOLVER)
    mp_, ms_ = p["mini_params"], p["mini_state"]

    # data parallelism: the step (plain and remat), inference, eval
    local = shard_batch(mesh, batch, batch_axis=1)
    out["dp_step"] = _step(make_sharded_train_step, mini_train, cfg, mesh, mp_, ms_, local)
    out["dp_step_remat"] = _step(make_sharded_train_step, mini_train, cfg, mesh, mp_, ms_,
                                 local, remat="dots")
    data = torch.from_numpy(p["infer_data"])
    out["dp_infer"] = make_sharded_infer_fn(mini_test, mesh)(
        tensors(mp_), tensors(ms_), data).numpy()
    eval_prog = Program(small_video_graph(True), device="cpu")
    trainer = Trainer(eval_prog, SolverConfig(), test_program=eval_prog, mesh=mesh,
                      log_fn=lambda *_: None)
    out["eval"] = trainer.test(init_train_state(tensors(mp_), tensors(ms_)),
                               iter([shard_batch(mesh, {k: torch.from_numpy(v) for k, v in b.items()})
                                     for b in p["eval_batches"]]))

    # segment sharding: data 1 x segment 2
    seg = make_mesh({"data": 1, "segment": 2})
    out["seg_step"] = _step(make_segment_sharded_train_step, mini_train, cfg, seg, mp_, ms_,
                            shard_batch(seg, batch, batch_axis=1, segment_axis=2))
    out["seg_infer"] = make_segment_sharded_infer_fn(mini_test, seg)(
        tensors(mp_), tensors(ms_), data[:2]).numpy()

    # tensor parallelism: data 1 x model 2
    tpm = make_mesh({"data": 1, "model": 2})
    out["tp_step"] = _step(make_tp_train_step, mini_train, cfg, tpm, mp_, ms_, batch, tp=True)
    sp, ss = shard_tp_tree(tpm, tensors(mp_)), shard_tp_tree(tpm, tensors(ms_))
    out["tp_numel"] = {f"{ln}/{k}": v.numel() for ln, lp in {**sp, **ss}.items()
                       for k, v in lp.items()}
    out["tp_infer"] = make_tp_infer_fn(mini_test, tpm)(sp, ss, data).numpy()
    wiring = Trainer(mini_train, SolverConfig(base_lr=0.01, lr_policy="fixed", max_iter=2,
                                              display=1, test_interval=0),
                     mesh=tpm, log_fn=lambda *_: None)
    ts = shard_tp_train_state(tpm, init_train_state(tensors(mp_), tensors(ms_)))
    one = {k: v[:1] for k, v in batch.items()}
    ts = wiring.solve(ts, iter([one, one]))
    out["tp_trainer"] = {"it": ts.it, "conv1_w": tuple(ts.params["conv1"]["w"].shape)}

    # the Gather/Scatter section: inference and a train step
    gp, gs = p["gsec_params"], p["gsec_state"]
    out["gsec_infer"] = make_sharded_infer_fn(Program(gather_section_graph(False),
                                                      device="cpu"), mesh)(
        tensors(gp), tensors(gs), torch.from_numpy(p["gsec_data"])).numpy()
    gbatch = {k: torch.from_numpy(v) for k, v in p["gsec_batch"].items()}
    out["gsec_step"] = _step(make_sharded_train_step,
                             Program(gather_section_graph(True), train=True, device="cpu"),
                             SolverConfig(base_lr=0.1, lr_policy="fixed", iter_size=1),
                             mesh, gp, gs, shard_batch(mesh, gbatch, batch_axis=1))

    # full ECO-Lite at crop 64: one data-parallel step
    g = build_eco_lite(num_classes=10, num_segments=4, crop_size=64, with_loss=True, batch=8)
    prog = Program(g, train=True, device="cpu")
    eb = {k: torch.from_numpy(v) for k, v in p["eco_batch"].items()}
    params, state = prog.init(torch.Generator().manual_seed(0),
                              {k: v[0] for k, v in eb.items()})
    step = make_sharded_train_step(prog, SolverConfig(base_lr=0.001, iter_size=1,
                                                      clip_gradients=40.0), mesh)
    ts, m = step(init_train_state(params, state), shard_batch(mesh, eb, batch_axis=1),
                 torch.Generator().manual_seed(3))
    out["eco_lite"] = {"loss": float(m["loss"]), "it": ts.it,
                       "digest": params_digest(ts.params)}
    return out


def export_mesh(rank, world, p):
    """The mesh artifact: export the per-rank shard, save, load, call on the
    global batch; and the export's errors."""
    from eco_tpu_torch.convert import export_serving, load_serving_artifact, save_serving_artifact
    from eco_tpu_torch.parallel import make_mesh
    from eco_tpu_torch.runtime import Program

    prog = Program(small_video_graph(False), device="cpu")
    params, state = tensors(p["params"]), tensors(p["state"])
    mesh = make_mesh()
    exported = export_serving(prog, params, state, batch=8, segments=4, crop=16, mesh=mesh)
    path = os.path.join(p["dir"], "mesh.pt2")
    if rank == 0:
        save_serving_artifact(exported, path)
    torch.distributed.barrier()
    got = load_serving_artifact(path, device="cpu")(torch.from_numpy(p["data"]))
    errors = {}
    for name, kw in (("batch", dict(batch=7)), ("dynamic", dict(batch=8, dynamic_batch=True))):
        try:
            export_serving(prog, params, state, segments=4, crop=16, mesh=mesh, **kw)
        except ValueError as e:
            errors[name] = str(e)
    placeholders = [n for n in exported.graph.nodes if n.op == "placeholder"
                    and n.name in exported.graph_signature.user_inputs]
    return {"probs": got.numpy(), "errors": errors,
            "in_shape": tuple(placeholders[0].meta["val"].shape)}


def trainer_dp(rank, world, p):
    """Trainer(mesh=) over the mini graph: ``iters`` data-parallel steps on
    this rank's shard of each global batch, a snapshot at the end under a
    prefix of the rank's own (so a write by any other rank than 0 shows)."""
    from eco_tpu_torch.parallel import make_mesh, shard_batch
    from eco_tpu_torch.parallel.multiprocess import params_digest
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state

    mesh = make_mesh()
    cfg = SolverConfig(**MINI_SOLVER, max_iter=len(p["batches"]), display=1,
                       snapshot=len(p["batches"]),
                       snapshot_prefix=os.path.join(p["dir"], f"rank{rank}", "snap"))
    trainer = Trainer(Program(small_video_graph(True), train=True, device="cpu"), cfg,
                      mesh=mesh, log_fn=lambda *_: None)
    ts = init_train_state(tensors(p["params"]), tensors(p["state"]))
    local = [shard_batch(mesh, {k: torch.from_numpy(v) for k, v in b.items()}, batch_axis=1)
             for b in p["batches"]]
    ts = trainer.solve(ts, iter(local))
    return {"params": arrays(ts.params), "it": ts.it, "digest": params_digest(ts.params)}


def four_rank_suite(rank, world, p):
    """DP x TP (data 2 x model 2) and DP x segment (data 2 x segment 2)
    train steps of the mini graph on 4 ranks, each on its shard."""
    from eco_tpu_torch.parallel import (
        make_mesh, make_segment_sharded_train_step, make_tp_train_step, shard_batch,
    )
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import SolverConfig

    prog = Program(small_video_graph(True), train=True, device="cpu")
    cfg = SolverConfig(**MINI_SOLVER)
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    tpm = make_mesh({"data": 2, "model": 2})
    seg = make_mesh({"data": 2, "segment": 2})
    return {
        "tp_step": _step(make_tp_train_step, prog, cfg, tpm, p["mini_params"], p["mini_state"],
                         shard_batch(tpm, batch, batch_axis=1), tp=True),
        "seg_step": _step(make_segment_sharded_train_step, prog, cfg, seg, p["mini_params"],
                          p["mini_state"],
                          shard_batch(seg, batch, batch_axis=1, segment_axis=2)),
    }
