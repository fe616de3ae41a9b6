"""Multi-process runs of the data-parallel and view-sharded paths.

The counterparts of ``__graft_entry__.py:61-273`` (``dryrun_multichip``,
``_dryrun_inline``, ``multihost_train_losses``), and the rank launcher
that the tests and ``chip_smoke.py`` share:

- ``run_ranks`` spawns one process a rank over a ``file://`` rendezvous
  (no port, so concurrent runs cannot collide). Each rank writes its
  output to a file, never a pipe: a full pipe would stall that rank inside
  a collective while its peers wait (``__graft_entry__.py:158-162``).
  Every wait has a timeout, and a failed or late rank raises with the
  tails of the rank logs;
- ``train_steps`` / ``train_rank``: steps of ``trainer.make_train_step``
  on a batch, in one process or as one rank of a group;
- ``multihost_train_losses`` runs the training CLI as ``n_procs``
  processes with ``TRAIN.DEVICE multihost`` on the CPU (gloo);
- ``dryrun_multichip(n)`` runs ``_dryrun_inline(n)`` in a fresh
  interpreter: one data-parallel step over n ranks, the view-sharded abl04
  forward over n shards against the monolithic one, and (n >= 2) the CLI
  over 2 processes against 1.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def _tails(logs: Sequence[Path], codes) -> str:
    return "\n".join(
        f"--- rank {r} (exit code {c}) ---\n"
        + (p.read_text()[-2500:] if p.exists() else "(no log)")
        for r, (p, c) in enumerate(zip(logs, codes)))


def _rank_entry(fn: Callable, rank: int, world: int, init_method: str,
                args: tuple, log: str, result: str) -> None:
    with open(log, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    sys.stdout.reconfigure(line_buffering=True)
    out = fn(rank, world, init_method, *args)
    torch.save(out, result)


def run_ranks(fn: Callable, world: int, work_dir, args: tuple = (),
              timeout: float = 120.0) -> List:
    """``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes (``fn`` joins the group itself); each rank's result (saved
    with ``torch.save``), in rank order. Logs: ``work_dir/rank{r}.log``."""
    import multiprocessing

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "rendezvous"
    if store.exists():
        store.unlink()
    init = f"file://{store}"
    logs = [work / f"rank{r}.log" for r in range(world)]
    results = [work / f"rank{r}.pt" for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, init, args, str(logs[r]),
                               str(results[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        late = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if any(late) or any(c != 0 for c in codes):
        what = f"still running after {timeout} s" if any(late) else "failed"
        raise RuntimeError(f"{world} ranks of {getattr(fn, '__name__', fn)}"
                           f": {what}\n{_tails(logs, codes)}")
    return [torch.load(r, weights_only=False) for r in results]


def _launches() -> Dict[str, int]:
    from ..ops.bilinear_sample import warp_sample, warp_sample_grad
    return {"bilinear_sample": warp_sample.launches,
            "warp_sample_grad": warp_sample_grad.launches}


def train_steps(config: dict, batch: dict, steps: int, device,
                world_size: int = 1, state_dict: dict = None,
                seed: int = 0) -> dict:
    """``steps`` steps of ``make_train_step`` on one numpy batch from the
    seeded initialization (or ``state_dict``), at ``world_size`` for the
    LR schedule: {"losses", "ms" (host clock a step, synchronized),
    "params", "stats" (running statistics), "launches" (of the sample and
    its backward kernel in the steps)}."""
    from ..train import trainer as pt
    device = torch.device(device)
    model, state = pt.create_train_state(
        config, torch.Generator().manual_seed(seed), 200,
        world_size=world_size, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    step = pt.make_train_step(model, config)
    dev_batch = pt.batch_to_device(batch, device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    before = _launches()
    losses, ms = [], []
    sync()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, dev_batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    after = _launches()
    return {"losses": losses, "ms": ms,
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "launches": {k: after[k] - before[k] for k in after}}


def train_rank(rank: int, world: int, init_method: str, config: dict,
               batch: dict, steps: int, device: str, backend: str = None,
               state_dict: dict = None) -> dict:
    """``train_steps`` as rank ``rank`` of ``world`` on its rows of the
    global ``batch``."""
    from ..train import trainer as pt
    dev = torch.device(device)
    if dev.type == "cpu":
        # One thread a rank: a rank's idle OpenMP threads spin, and on a
        # loaded host they starve its peer inside each collective (two
        # ranks' 64x64 steps took 35-100 s each instead of 0.5).
        torch.set_num_threads(1)
    pt.init_process_group(dev, init_method, world, rank, backend)
    try:
        return train_steps(config, pt.shard_batch(batch, rank, world),
                           steps, dev, world, state_dict)
    finally:
        torch.distributed.destroy_process_group()


def example_batch(B: int, V: int, H: int, W: int, rng=None) -> dict:
    """A seeded synthetic training batch (``__graft_entry__._example_batch``):
    random images, a camera moving 0.1 a view along x, depths in [1, 5]."""
    rng = rng or np.random.RandomState(0)
    K3 = np.array([[0.6 * W, 0, (W - 1) / 2], [0, 0.6 * W, (H - 1) / 2],
                   [0, 0, 1]], np.float32)
    Ks = {}
    for stage, s in (("stage1", 0.25), ("stage2", 0.5), ("stage3", 1.0)):
        K = K3.copy()
        K[:2] *= s
        Ks[stage] = {"K": np.broadcast_to(K, (B, 3, 3)).copy()}
    c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy()
    for v in range(V):
        c2w[:, v, 0, 3] = 0.1 * v
    return {
        "image": rng.rand(B, V, 3, H, W).astype(np.float32),
        "intrinsics": Ks,
        "cam_to_world": c2w,
        "depth_min": np.full((B,), 0.5, np.float32),
        "depth_max": np.full((B,), 6.0, np.float32),
        "depth": {s: rng.rand(B, H // f, W // f).astype(np.float32) * 4 + 1
                  for s, f in (("stage1", 4), ("stage2", 2), ("stage3", 1))},
        "mask": {s: np.ones((B, H // f, W // f), np.float32)
                 for s, f in (("stage1", 4), ("stage2", 2), ("stage3", 1))},
    }


def multihost_train_losses(n_procs: int, out_base: str, max_steps: int = 2,
                           extra_overrides: Sequence[str] = (),
                           global_batch: int = 2,
                           timeout: float = 600.0) -> List[float]:
    """The training CLI as ``n_procs`` processes with ``TRAIN.DEVICE
    multihost`` on the CPU (``TANDEM_PLATFORM=cpu``, gloo, a localhost
    rendezvous), on ``tests/fixtures/replica_traj`` at 96x128 with planes
    (8, 8, 4); rank 0's loss a step. The global batch is ``global_batch``
    at every ``n_procs`` and the LR is set so that the schedule is the
    same too (the CLI scales it by the ranks), so runs with different
    ``n_procs`` take the same steps. All ranks share ``out_base/run``;
    rank r logs to ``out_base/rank{r}.log``."""
    from ..train.trainer import free_port
    overrides = [
        "TRAIN.DEVICE", "multihost",
        "TRAIN.MAX_STEPS", str(max_steps),
        "TRAIN.BATCH_SIZE", str(global_batch // n_procs),
        "TRAIN.LR", repr(1e-3 * global_batch / n_procs),
        "TRAIN.NUM_WORKERS", "0",
        "MODEL.DEPTH_NUM", "(8,8,4)",
        "DATA.ROOT_DIR", str(REPO / "tests" / "fixtures" / "replica_traj"),
        "DATA.IMG_HEIGHT", "96", "DATA.IMG_WIDTH", "128",
        "IO.LOG_INTERVAL", "1",
        "IO.SUMMARIES", "()",
    ] + list(extra_overrides)
    base = Path(out_base)
    base.mkdir(parents=True, exist_ok=True)
    port = free_port()
    logs = [base / f"rank{r}.log" for r in range(n_procs)]
    procs = []
    for r in range(n_procs):
        env = dict(os.environ, TANDEM_PLATFORM="cpu", OMP_NUM_THREADS="1",
                   TANDEM_COORDINATOR=f"127.0.0.1:{port}",
                   TANDEM_NUM_PROCESSES=str(n_procs),
                   TANDEM_PROCESS_ID=str(r))
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tandem_tpu_torch.cli.tandem_train",
                 str(base / "run")] + overrides, env=env, cwd=str(REPO),
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"multihost run failed:\n{_tails(logs, codes)}")
    losses = [float(m) for m in re.findall(r"step \d+ loss ([0-9.]+)",
                                           logs[0].read_text())]
    if len(losses) < max_steps:
        raise RuntimeError(f"expected {max_steps} loss lines from rank 0, "
                           f"got {len(losses)}:\n{_tails(logs[:1], codes)}")
    return losses


def _dryrun_inline(n_devices: int, device: str) -> None:
    """The dry run's body: one data-parallel step over ``n_devices`` gloo
    ranks on ``device`` (B = n, V = 2, 32x32); the view-sharded abl04
    forward ((48, 4, 4) planes, V = 7, bf16, 160x128) over ``n_devices``
    shards of ``device`` within 2e-2 relative of the monolithic one, with
    its sums; and for n >= 2 the CLI over 2 processes against 1 on the CPU
    (losses within 5e-3 relative)."""
    import tempfile

    from .. import config as cfg
    from ..models.cva_mvsnet import CvaMVSNet
    from ..train.trainer import init_parameters
    from . import collectives
    from .view_shard import build_view_sharded_forward

    config = cfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "TRAIN.BATCH_SIZE": 1})
    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(train_rank, n_devices, Path(tmp) / "dp",
                        (config, example_batch(n_devices, 2, 32, 32), 1,
                         device, "gloo"))
    print(f"dryrun_multichip({n_devices}): {n_devices} ranks on {device}, "
          f"loss={out[0]['losses'][0]:.4f}", flush=True)

    V, H, W = 7, 128, 160
    model = CvaMVSNet(view_aggregation=True, depth_num=(48, 4, 4),
                      dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(device)
    b = example_batch(1, V, H, W)
    args = (torch.from_numpy(b["image"]).to(device),
            tuple(torch.from_numpy(b["intrinsics"][s]["K"]).to(device)
                  for s in ("stage1", "stage2", "stage3")),
            torch.from_numpy(b["cam_to_world"]).to(device),
            torch.from_numpy(b["depth_min"]).to(device),
            torch.from_numpy(b["depth_max"]).to(device))
    fwd = build_view_sharded_forward(model, [device] * n_devices)
    with collectives.record() as payloads:
        d, _ = fwd(*args)
    link = collectives.link_bytes_per_card(payloads, n_devices)
    ref = model(*args).stage3.depth
    rel = float((d - ref).abs().max()) / max(float(ref.abs().max()), 1e-9)
    if not rel < 2e-2:
        raise AssertionError(f"view-sharded inference mismatch: rel {rel}")
    print(f"dryrun_multichip({n_devices}): view-sharded abl04 (48,4,4) V=7 "
          f"{W}x{H} bf16 inference rel err {rel:.2e}; "
          f"{link['n_collectives']} sums, payload "
          f"{link['payload_bytes'] / 1e6:.2f} MB, ring "
          f"{link['link_bytes'] / 1e6:.2f} MB a card", flush=True)

    if n_devices >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            multi = multihost_train_losses(2, os.path.join(tmp, "mh"))
            single = multihost_train_losses(1, os.path.join(tmp, "sp"))
        np.testing.assert_allclose(multi, single, rtol=5e-3, atol=1e-5)
        print(f"dryrun_multichip({n_devices}): 2-process multihost CLI "
              f"losses {multi} == 1 process {single}", flush=True)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 900.0) -> str:
    """``_dryrun_inline(n_devices, device)`` in a fresh interpreter (so no
    process group or CUDA state of the caller's leaks in); its output. A
    failure or a run past ``timeout`` raises with the output's tail."""
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "from tandem_tpu_torch.parallel.dryrun import _dryrun_inline\n"
            f"_dryrun_inline({n_devices}, {device!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed (exit "
                           f"code {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    return proc.stdout
