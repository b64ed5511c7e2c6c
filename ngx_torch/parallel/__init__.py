"""The env batch sharded over devices — the port of
``ngx/parallel/__init__.py`` on ``torch.distributed``.

ngx runs one controller over a ``Mesh`` of the local chips.  Here one
process drives one device: the rank is the mesh position and the world size
is the mesh's size (:class:`EnvMesh`).  Rank ``k`` of ``W`` holds the global
env rows ``[k*B/W, (k+1)*B/W)``.  Stepping is elementwise along the batch,
so the env path has no collective; the global quantities come from explicit
all-reduces — the metric reductions and the learner's gradient mean
(:mod:`ngx_torch.rl.train`).  Every collective goes through
:meth:`EnvMesh.all_reduce` or :meth:`EnvMesh.broadcast`, which record it in
the mesh's ``log``: the port's stand-in for ngx's compiled-HLO audit
(``tests/test_distributed.py:146-214``).

Backends: NCCL on the card, gloo on the CPU, chosen by the device unless
``backend=`` names one.  Two ranks on one card need gloo over CUDA tensors,
because NCCL refuses two ranks on one device: ask for it with
``backend='gloo'``.  Nothing switches from one backend to another by itself,
and a failed ``init_process_group`` raises.

:func:`make_local_meshes` is the in-process twin: ``W`` meshes whose
collectives sum the ranks' tensors by hand in rank order, for ``W`` threads
of one process.  :func:`spawn_ranks` starts one process per rank (gloo on
the CPU, NCCL or gloo on the card), each with a time limit.

The sharded trainer draws from ngx's keys only: a rank takes its rows of
ngx's per-env key split (:func:`host_local_keys` given a key) and its
permutations from ``fold_in(k_upd, rank)``, so a shard draws the global
batch's states.  Given an int seed, :func:`host_local_keys` gives the
rank's rows of the counter streams instead, the form of the kernels' plain
twins.  The stepping functions here (:func:`sharded_throughput_
fn`, :func:`make_spmd_rollout`) take the same two forms: ``rng='threefry'``
is ngx's scan on ngx's keys in plain torch (no kernel: XLA in ngx), the
default ``rng='counter'`` the 'prng' kernel on the counter RNG.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core.state import make_state_packers
from ..ops import threefry as TF
from ..ops.rng import _BLOCK_SEED_STRIDE, block_streams
from ..ops.tables import resolve_device, seed_i32
from ..utils import debug
from ..vector import RNGS, KeyedVecEnv, VecEnv

# the per-rank offset of the acting kernel's seed (ngx/rl/train.py:362)
SHARD_SEED_STRIDE = 612331
BACKENDS = ("nccl", "gloo")


def shard_seed(seed: int, rank: int) -> int:
    """The acting seed of shard ``rank``: ``seed + rank*612331`` wrapped to
    int32 (Python ints do not wrap), ngx's ``seed + axis_index('env') *
    int32(612331)`` (``ngx/rl/train.py:362``, ``:377``)."""
    return seed_i32(int(seed) + int(rank) * SHARD_SEED_STRIDE)


class _LocalGroup:
    """The in-process twin's group: ``size`` threads meet at a barrier and
    each reads the sum of the ranks' tensors, added by hand in rank order."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)

    def all_reduce(self, rank, t):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for s in self.slots[1:]:
            total += s
        self.barrier.wait()
        t.copy_(total)

    def broadcast(self, rank, t, src):
        if rank == src:
            self.slots[src] = t.clone()
        self.barrier.wait()
        t.copy_(self.slots[src])
        self.barrier.wait()


@dataclasses.dataclass(frozen=True, eq=False)
class EnvMesh:
    """One rank's view of the env mesh: its ``rank`` of ``size``, its
    ``device``, and the group its collectives run in — a
    ``torch.distributed`` group, the in-process twin's, or None at size 1
    without a process group (a collective is then the identity).  ``log``
    holds ``(op, tag, bytes)`` of each collective it ran, in order.
    ngx's mesh axis name has no counterpart: a ``torch.distributed`` group
    has no named axes, and the rank is the position on the one env axis."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    log: list = dataclasses.field(default_factory=list, repr=False)

    def rows(self, n: int):
        """``(lo, hi)``: this rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks")
        loc = n // self.size
        return self.rank * loc, (self.rank + 1) * loc

    def _record(self, op, tag, t):
        self.log.append((op, tag, t.numel() * t.element_size()))

    def all_reduce(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        self._record("all_reduce", tag, t)
        if isinstance(self.group, _LocalGroup):
            self.group.all_reduce(self.rank, t)
        elif self.size > 1 or self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, tag: str, src: int = 0):
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        self._record("broadcast", tag, t)
        if isinstance(self.group, _LocalGroup):
            self.group.broadcast(self.rank, t, src)
        elif self.size > 1 or self.group is not None:
            dist.broadcast(t, src, group=self.group)
        return t


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            return resolve_device(device)        # raises: no card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(device)


def make_env_mesh(n_devices: Optional[int] = None,
                  device="cuda") -> EnvMesh:
    """This process's :class:`EnvMesh`: over the process group
    (:func:`initialize_distributed`) if there is one, else rank 0 of 1.
    ``n_devices``, as ngx's, must then be the world size: one process drives
    one device, ``device`` (on the card, ``LOCAL_RANK`` or the rank modulo
    the cards here; two ranks share a card when there are fewer cards than
    ranks)."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        rank, size, group, backend = 0, 1, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{size} processes: the port runs one process per "
                         "device (initialize_distributed)")
    device = _rank_device(device, rank)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend with device {device}: NCCL "
                         "runs on the card only")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return EnvMesh(rank, size, device, group)


def make_local_meshes(size: int, device="cuda") -> list:
    """The in-process twin: ``size`` meshes sharing one hand-summed group,
    each to be driven by its own thread."""
    group = _LocalGroup(size)
    dev = _rank_device(device, 0)
    return [EnvMesh(r, size, dev, group) for r in range(size)]


def pick_backend(device, backend: Optional[str] = None) -> str:
    """``backend`` when given, else NCCL for a CUDA device and gloo for the
    CPU; raises for NCCL off the card or an unknown name."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend with device {dev}: pass "
                         "backend='gloo' or a CUDA device")
    return backend


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda") -> str:
    """``init_process_group`` over TCP, once per process, before
    :func:`make_env_mesh` — the counterpart of ``jax.distributed.
    initialize``.  ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` URL) of rank 0; without it the rendezvous comes from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), as jax autodetects its cluster.  The backend
    is :func:`pick_backend`'s; on the card the rank's device is made
    current first (``LOCAL_RANK`` or the rank, modulo the cards).  Returns
    the backend; raises where the group cannot be made."""
    backend = pick_backend(device, backend)
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in os.environ]
        if missing:
            raise ValueError(f"no coordinator address and no {missing} in "
                             "the environment (torchrun sets them)")
        init = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(_rank_device(device, process_id))
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return backend


class LocalKeys(NamedTuple):
    """A rank's envs: the global rows ``[lo, hi)`` and their counter-RNG
    streams ``(seeds, rows)`` (:func:`ngx_torch.ops.rng.block_streams`)."""
    lo: int
    hi: int
    seeds: torch.Tensor
    rows: torch.Tensor


def host_local_keys(seed, global_batch: int, mesh: EnvMesh):
    """The rank's rows of a global batch: each rank makes only its own
    shard, as ngx's multi-host feed does (``ngx/parallel/__init__.py:202``).

    Given a key (an int64 ``[2]`` tensor, :mod:`ngx_torch.ops.threefry`),
    ngx's form: rows ``[lo, hi)`` of ``split(key, global_batch)``, int64
    ``[hi - lo, 2]`` on the mesh's device.  Given an int seed, the counter
    form: a :class:`LocalKeys` of the rows and their streams under
    ``seed``, the batch one RNG block (as :func:`~ngx_torch.core.reset.
    counter_reset`'s)."""
    lo, hi = mesh.rows(global_batch)
    if isinstance(seed, torch.Tensor):
        return TF.split_at(seed.to(mesh.device, torch.int64),
                           torch.arange(lo, hi, device=mesh.device))
    seeds, rows = block_streams(seed, hi - lo, global_batch, mesh.device,
                                offset=lo)
    return LocalKeys(lo, hi, seeds, rows)


def episode_metrics(traj, mesh: Optional[EnvMesh] = None) -> dict:
    """ngx's per-batch reductions of a :class:`~ngx_torch.vector.Trajectory`
    (mean reward, episodes finished, mean step cost, steps): the local sums,
    then one all-reduce over ``mesh`` for the global values."""
    sums = torch.stack([traj.rewards.sum(dtype=torch.float64),
                        traj.dones.sum(dtype=torch.float64),
                        traj.step_costs.sum(dtype=torch.float64),
                        torch.tensor(float(traj.rewards.numel()),
                                     dtype=torch.float64,
                                     device=traj.rewards.device)])
    if mesh is not None:
        mesh.all_reduce(sums, "metrics")
    r, d, c, n = sums
    return {"mean_reward": (r / n).to(torch.float32),
            "episodes_finished": d.to(torch.int64),
            "mean_step_cost": (c / n).to(torch.float32),
            "steps": n.to(torch.int64)}


def make_sharded_vec(spec, mesh: EnvMesh, episode_cap: Optional[int] = None,
                     reset_obs: bool = False) -> VecEnv:
    """A :class:`~ngx_torch.vector.VecEnv` over the rank's rows: ``reset``
    takes the global batch and returns the rank's shard, and a shard's
    resets and random actions draw its global envs' streams, so the shards
    together are the unsharded env's batch bit for bit.  No collective."""
    return VecEnv(spec, episode_cap=episode_cap, reset_obs=reset_obs,
                  mesh=mesh)


def _shard_rollout(spec, mesh: EnvMesh, batch: int, steps: int,
                   packed: bool):
    """``launch(seed) -> (local state, mean_reward, episodes)``: the rank's
    shard through the 'prng' rollout kernel (:func:`ngx_torch.ops.rollout.
    rollout`; its packed variant when ``packed``), then one all-reduce of
    the shard's float32 reward sum and done count.  The RNG block is 512
    envs where the shard allows it, else the shard; the rank's seed is
    ``seed + (lo / block) * 7919`` in int32, the stream of its first block
    in the global batch, so the shards draw ``throughput_fn(spec, batch)``'s
    streams wherever that batch's block is the shard's.  Under
    ``NGX_DEBUG=1`` it refuses to build, as :func:`~ngx_torch.ops.rollout.
    make_rollout` does."""
    from ..ops.rollout import _check_args, rollout

    debug.refuse_kernel("the plain step path (ngx_torch.vector.VecEnv)")
    lo, hi = mesh.rows(batch)
    loc = hi - lo
    block = 512 if loc % 512 == 0 else loc
    _check_args(spec, loc, steps, block, "prng", None, packed=packed)
    first = lo // block

    def launch(seed: int):
        state, rsum, dcount = rollout(
            spec, loc, steps, seed_i32(int(seed) + first * _BLOCK_SEED_STRIDE),
            block, "prng", device=mesh.device, packed=packed)
        sums = torch.stack([rsum.sum().to(torch.float64),
                            dcount.sum().to(torch.float64)])
        mesh.all_reduce(sums, "metrics")
        mean = (sums[0] / max(batch * steps, 1)).to(torch.float32)
        return state, mean, sums[1].to(torch.int64)

    return launch


def _keyed_scan(spec, mesh: EnvMesh, batch: int, steps: int,
                local: bool, packed: bool):
    """``launch(key) -> (local state, mean_reward, episodes)`` on ngx's keys
    (a key tensor, or an int for ``key(int)``), plain torch on the mesh's
    device (XLA in ngx: no kernel).  The rank's envs start from its rows
    ``[lo, hi)`` of ``split(key, batch)`` (ngx's native reset), then
    :meth:`~ngx_torch.vector.KeyedVecEnv.scan` runs ``steps`` random-action
    steps: with ``local`` the shard's own scan, as ngx's ``shard_map``
    (``ngx/parallel/__init__.py:126-163``): ``fold_in(<the rank's first
    key>, 17)`` and draws of the shard's size; else the global scan of
    ``fold_in(split(key, batch)[0], 1)``, the rank taking its rows of the
    global draws (``:61-83``).  Then one all-reduce of the shard's float32
    reward sum and done count."""
    lo, hi = mesh.rows(batch)
    vec = KeyedVecEnv(spec)
    packers = make_state_packers(spec)[:2] if packed else None

    def launch(key):
        key = TF.as_key(key, mesh.device)
        state, _ = vec.reset(TF.split_at(
            key, torch.arange(lo, hi, device=mesh.device)))
        if local:
            state, r_sum, d_sum = vec.scan(
                state, TF.fold_in(TF.split_at(key, lo), 17), steps,
                packers=packers)
        else:
            state, r_sum, d_sum = vec.scan(
                state, TF.fold_in(TF.split_at(key, 0), 1), steps,
                batch=batch, offset=lo, packers=packers)
        sums = torch.stack([r_sum.to(torch.float64),
                            d_sum.to(torch.float64)])
        mesh.all_reduce(sums, "metrics")
        mean = (sums[0] / max(batch * steps, 1)).to(torch.float32)
        return state, mean, sums[1].to(torch.int64)

    return launch


def sharded_throughput_fn(spec, mesh: EnvMesh, batch: int, steps: int,
                          rng: str = "counter"):
    """The env-stepping benchmark over the mesh (ngx's, ``ngx/parallel/
    __init__.py:61``): ``launch(seed) -> (the rank's final state,
    mean_reward, episodes_done)``, ``batch`` random-action envs split over
    the ranks.  ``rng='threefry'``: ngx's draws from ngx's key
    (``launch(key)``; :func:`_keyed_scan`'s global scan), the rank's state
    its rows of ngx's, plain torch.  ``rng='counter'`` (the default): each
    rank's shard one launch of the 'prng' kernel on the counter RNG of
    :func:`~ngx_torch.vector.throughput_fn` (see :func:`_shard_rollout` for
    a rank's seed)."""
    if rng == "threefry":
        return _keyed_scan(spec, mesh, batch, steps, local=False,
                           packed=False)
    _check_rng(rng)
    return _shard_rollout(spec, mesh, batch, steps, packed=False)


def make_spmd_rollout(spec, mesh: EnvMesh, batch: int, steps: int,
                      packed: bool = False, rng: str = "counter"):
    """ngx's explicit-SPMD rollout (``ngx/parallel/__init__.py:86``):
    ``launch(seed) -> (mean_reward, episodes_done)``, each rank stepping its
    ``batch / size`` envs, the only traffic one all-reduce of the metrics.
    ``rng='threefry'``: ngx's draws from ngx's key (``launch(key)``;
    :func:`_keyed_scan`'s shard-local scan), plain torch; ``packed=True``
    carries the state packed between steps, as ngx's scan does.
    ``rng='counter'`` (the default): the 'prng' kernel, ``packed=True``
    its packed variant, which writes the final state in
    :func:`~ngx_torch.core.state.make_state_packers`' words.  Packed or
    not, the same results bit for bit."""
    if rng == "threefry":
        run = _keyed_scan(spec, mesh, batch, steps, local=True,
                          packed=packed)
    else:
        _check_rng(rng)
        run = _shard_rollout(spec, mesh, batch, steps, packed=packed)

    def launch(seed):
        _, mean, episodes = run(seed)
        return mean, episodes

    return launch


def _check_rng(rng):
    if rng not in RNGS:
        raise ValueError(f"rng {rng!r} is not one of {RNGS}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(x):
    """Tensors (and states) as numpy, through lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(results, target, rank, nprocs, address, device, backend,
               args):
    torch.set_num_threads(1)
    try:
        initialize_distributed(address, nprocs, rank, backend=backend,
                               device=device)
        out = target(make_env_mesh(device=device), *args)
        results.put((rank, "ok", _to_host(out)))
    except BaseException:                         # noqa: B036 — reported
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target, nprocs: int, args=(), *, device="cuda",
                backend: Optional[str] = None, timeout: float = 600.0):
    """Run ``target`` in ``nprocs`` new processes, one per rank, and return
    their results in rank order (tensors as numpy).

    Each process (one torch CPU thread) joins one group over
    ``tcp://localhost:<free port>`` (:func:`initialize_distributed` with
    ``backend`` and ``device``), calls ``target(make_env_mesh(device=
    device), *args)`` and leaves the group in a ``finally``.  ``target``
    must be importable (a module-level function; the caller's main guarded
    by ``if __name__ == "__main__"``).  A rank that raises or dies ends the
    run with a ``RuntimeError`` naming it; no result from every rank within
    ``timeout`` seconds raises ``TimeoutError``; either way every process is
    stopped.  ``device`` is the card by default (NCCL, one rank a card;
    ``"cpu"`` for gloo ranks on the CPU).  NCCL with more ranks than this
    host's cards raises at once, since NCCL refuses two ranks on one card:
    pass ``backend='gloo'`` for that."""
    import multiprocessing as mp

    resolve_device(device)                    # raises: the card, if none
    backend = pick_backend(device, backend)
    if (backend == "nccl" and torch.device(device).type == "cuda"
            and nprocs > torch.cuda.device_count()):
        raise ValueError(
            f"{nprocs} NCCL ranks on {torch.cuda.device_count()} card(s): "
            "NCCL refuses two ranks on one card; pass backend='gloo'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        results, target, r, nprocs, address, str(device), backend,
        tuple(args))) for r in range(nprocs)]
    out = {}
    name = getattr(target, "__qualname__", str(target))
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(nprocs) if r not in out]
                raise TimeoutError(f"{name}: no result from ranks {missing} "
                                   f"of {nprocs} within {timeout} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:            # its last words may still be in the pipe
                        rank, status, value = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"{name}: rank {dead[0]} of {nprocs} exited "
                            f"with code {procs[dead[0]].exitcode} without a "
                            "result") from None
                else:
                    continue
            if status != "ok":
                raise RuntimeError(f"{name}: rank {rank} of {nprocs} "
                                   f"failed:\n{value}")
            out[rank] = value
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            p.join(timeout=10.0 if len(out) == nprocs else 0.1)
        for p in started:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(nprocs)]
