"""Several ranks on one map: frame data-parallelism and direction
tensor-parallelism over ``torch.distributed``.

Twin of the JAX package's parallel/sharding.py, with its two axes:

  * ``batch`` (data parallel): a batch of frames is split over the ranks;
    each runs preprocess + Hough extraction + frame transform on its frames;
    the frame segments are gathered in global frame order and fused into the
    world map *sequentially in frame order* on every rank (fusion is
    order-dependent, node.cpp:491-510, so it is replicated, not split).
  * ``dir`` (tensor parallel): the direction sphere is split; every rank
    votes its slice of directions over the replicated cloud, and each round
    gathers the ranks' winners (ops/hough.py `AxisGroup`).

Where the JAX package has one program that `shard_map` cuts up, this is SPMD:
every rank of the default process group calls `make_mesh` and then the
function a factory returns, with the same arguments.  `spawn` starts such
ranks as processes of one host.  Inputs are replicated (every rank passes the
whole batch and takes its own frames), outputs are replicated (every rank
returns the whole result), and an n-rank run gives a one-rank run's bits.

Backend and device follow from the ranks and the cards, never from a failed
attempt: rank r works on ``cuda:(r % cards)``; NCCL carries the collectives
when every rank has a card of its own, else gloo with ranks sharing cards
(NCCL refuses two ranks on one GPU), and then the few words of each
collective are copied through the host (`AxisGroup.all_gather`).  The voting
kernels run on the card in both cases.  ``device="cpu"`` is gloo on CPU
tensors with the kernels' plain versions, as the tests run it.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..ops.hough import KERNELS, AxisGroup, SegmentBatch, Voting
from ..pipeline import compute_dtype, frame_segments, process_frame
from ..sphere import hough_space
from ..worldmap import world_step

# seconds a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 120.0


class Mesh(NamedTuple):
    """This rank's place on a ('batch', 'dir') mesh of the default group."""

    n_batch: int
    n_dir: int
    batch_index: int            # -1 on a rank the mesh leaves out
    dir_index: int
    dir_group: Optional[AxisGroup]    # this rank's row; None when n_dir == 1
    batch_group: Optional[AxisGroup]  # this rank's column; None when n_batch == 1
    device: torch.device

    @property
    def member(self) -> bool:
        return self.batch_index >= 0


def make_mesh(n_batch: Optional[int] = None, n_dir: int = 1, device="cuda") -> Mesh:
    """A ('batch', 'dir') mesh over the ranks of the default process group:
    rank r sits at (r // n_dir, r % n_dir).  Every rank of the group must
    call it, with the same arguments, since every rank has to create every
    sub-group in the same order; ranks beyond n_batch * n_dir get a mesh
    that is not a `member`.  `device` is where this rank's tensors live:
    "cuda" (the default) is this rank's card, ``cuda:(rank % cards)`` as
    `spawn` hands them out, and raises without a card; "cpu" has to be asked
    for.  A collective of the mesh waits `COLLECTIVE_TIMEOUT_S` for the other ranks
    and then fails."""
    if n_dir < 1:
        raise ValueError(f"make_mesh: n_dir must be >= 1, got {n_dir}")
    if not dist.is_initialized():
        raise ValueError(
            "make_mesh: torch.distributed has no default process group; start "
            "the ranks with parallel.spawn(fn, n_ranks, device) or call "
            "dist.init_process_group in each of them first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_batch is None:
        n_batch = world // n_dir
    need = n_batch * n_dir
    if world < need or need == 0:
        raise ValueError(
            f"make_mesh: need {n_batch}x{n_dir}={need} ranks, have {world} "
            f"({dist.get_backend()}). Start that many with parallel.spawn(fn, "
            f"{max(need, 1)}, device): on device='cpu' they are gloo processes of "
            f"this host, on 'cuda' rank r takes cuda:(r % cards).")
    device = torch.device(device)
    if device.type == "cuda":
        _need_card(device)
        if device.index is None:
            device = rank_device(device, rank)
    via_host = dist.get_backend() == "gloo" and device.type == "cuda"
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    bi, di = (rank // n_dir, rank % n_dir) if rank < need else (-1, -1)
    dir_group = batch_group = None
    if n_dir > 1:
        for b in range(n_batch):
            g = dist.new_group([b * n_dir + d for d in range(n_dir)], timeout=timeout)
            if b == bi:
                dir_group = AxisGroup(g, di, n_dir, via_host)
    if n_batch > 1:
        for d in range(n_dir):
            g = dist.new_group([b * n_dir + d for b in range(n_batch)], timeout=timeout)
            if d == di:
                batch_group = AxisGroup(g, bi, n_batch, via_host)
    return Mesh(n_batch, n_dir, bi, di, dir_group, batch_group, device)


def _padded_dir_tables(cfg: PipelineConfig, n_dir: int, device):
    """Direction tables padded to a multiple of n_dir with copies of
    direction 0: a copy can at best tie with the original's counts and then
    loses the smallest-(b, cell) tie-break, so padding changes nothing while
    every rank's slice has one length.  The directions follow the config's
    compute type (through float32 they would void the float64 parity mode on
    every sharded path); the plane bases c1 and c2 are float32 by spec."""
    dirs, c1, c2 = (torch.tensor(t) for t in hough_space(cfg.granularity))
    pad = (-dirs.shape[0]) % n_dir
    if pad:
        dirs, c1, c2 = (torch.cat([t, t[:1].expand(pad, 3)]) for t in (dirs, c1, c2))
    return (dirs.to(device=device, dtype=compute_dtype(cfg)),
            c1.to(device=device, dtype=torch.float32),
            c2.to(device=device, dtype=torch.float32))


def _local_tables(cfg: PipelineConfig, mesh: Mesh) -> tuple:
    """This rank's contiguous slice of the padded tables."""
    if not mesh.member:
        raise ValueError("this rank is not a member of the mesh")
    tables = _padded_dir_tables(cfg, mesh.n_dir, mesh.device)
    rows = tables[0].shape[0] // mesh.n_dir
    return tuple(t[mesh.dir_index * rows:(mesh.dir_index + 1) * rows].contiguous()
                 for t in tables)


def _pack(tensors) -> torch.Tensor:
    """The tensors' bytes, one after the other."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


def _unpack(buf: torch.Tensor, like) -> list:
    """(ranks, nbytes) of `_pack`ed rows back into tensors shaped like `like`
    with the ranks' leading dimensions joined: bytes in, the same bytes out."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        part = buf[:, off:off + n].contiguous().view(t.dtype)
        out.append(part.reshape((buf.shape[0] * t.shape[0],) + tuple(t.shape[1:])))
        off += n
    return out


def _local_frames(mesh: Mesh, clouds, poss, quats, cfg, tables, voting):
    """This rank's frames of the batch through the per-frame stages, then
    every rank's, in global frame order: (segments stacked (F, ...), nlines
    (F,), statuses (F,)).  One gather of the packed bytes over 'batch'."""
    F = clouds.shape[0]
    if F % mesh.n_batch:
        raise ValueError(f"{F} frames do not divide over a batch axis of "
                         f"{mesh.n_batch}")
    per = F // mesh.n_batch
    segs, nlines, statuses = [], [], []
    for i in range(mesh.batch_index * per, (mesh.batch_index + 1) * per):
        _, _, _, hough, s = frame_segments(clouds[i], poss[i], quats[i], cfg, tables,
                                           voting, mesh.dir_group)
        segs.append(s)
        nlines.append(hough.nlines)
        statuses.append(hough.status)
    local = [torch.stack(f) for f in zip(*segs)] + [torch.stack(nlines),
                                                    torch.stack(statuses)]
    if mesh.batch_group is not None:
        local = _unpack(mesh.batch_group.all_gather(_pack(local)), local)
    return SegmentBatch(*local[:-2]), local[-2], local[-1]


def make_multichip_step(cfg: PipelineConfig, mesh: Mesh, voting: Voting = KERNELS):
    """A multi-frame map-building step over the mesh.

    step(state, clouds (F, N_raw, 3), positions (F, 3), quats (F, 4)) ->
    (state', nlines (F,), statuses (F,)), called by every rank with the same
    arguments.  F must divide by the mesh's batch size.  Each rank runs its
    F / n_batch frames (its slice of the direction table, if n_dir > 1), the
    segments are gathered over 'batch', and the fusion runs over all F frames
    in order on every rank, so every rank returns the same world state."""
    tables = _local_tables(cfg, mesh)

    def step(state, clouds, poss, quats):
        segs, nlines, statuses = _local_frames(mesh, clouds, poss, quats, cfg,
                                               tables, voting)
        for i in range(clouds.shape[0]):
            state, _ = world_step(state, SegmentBatch(*(f[i] for f in segs)), cfg)
        return state, nlines, statuses

    return step


def make_tp_process_frame(cfg: PipelineConfig, mesh: Mesh, voting: Voting = KERNELS):
    """`pipeline.process_frame` with the direction sphere split over the
    mesh's 'dir' axis (cloud and world state replicated): step(state, raw,
    position, quat) -> (state', FrameOutput), the same on every rank of a
    row and bit-equal to one rank's."""
    tables = _local_tables(cfg, mesh)

    def step(state, raw, pos, quat):
        return process_frame(state, raw, pos, quat, cfg, tables, voting,
                             mesh.dir_group)

    return step


def make_batched_extract(cfg: PipelineConfig, mesh: Mesh, voting: Voting = KERNELS):
    """Data-parallel extraction without a world map: run(clouds, positions,
    quats) -> (SegmentBatch with a leading frame dimension F, nlines (F,),
    statuses (F,)), every frame's segments on every rank."""
    tables = _local_tables(cfg, mesh)

    def run(clouds, poss, quats):
        return _local_frames(mesh, clouds, poss, quats, cfg, tables, voting)

    return run


# ------------------------------------------------------------------ launcher

def _need_card(device) -> None:
    """No path leaves the card quietly: a CUDA device without a card raises."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but "
                           "torch.cuda.is_available() is False")


def rank_device(device, rank: int) -> torch.device:
    """Where rank `rank` works: "cpu", or ``cuda:(rank % cards)``."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device, n_ranks: int) -> str:
    """gloo on the CPU; on cards NCCL while every rank has its own, else
    gloo (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def _rank_main(rank, n_ranks, backend, device, rendezvous, threads, timeout_s,
               fn, args, results):
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{rendezvous}", world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": dev} if backend == "nccl" else {}))
        out = fn(rank, dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        results.put((rank, True, out))
    except BaseException:
        # reported before the group goes down: the other ranks then fail in
        # their next collective, and their reports must come second
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_ranks: int, device="cuda", args=(), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` in `n_ranks` processes of this host
    that form one default process group, and return their results by rank.

    `fn` must be importable (it is pickled by name) and returns something
    picklable (numpy, not tensors on a card).  device "cuda" (the default)
    raises without a card; rank r then works on ``cuda:(r % cards)``, over
    NCCL while n_ranks <= cards, else over gloo with ranks sharing cards.
    "cpu" is gloo with the host's cores shared out among the ranks.  The
    ranks meet through a file in a fresh temporary directory, so two calls
    at once cannot clash over a port.

    A rank that raises, or dies, fails the call: the others are ended and
    RuntimeError carries the traceback of every rank that failed, in the
    order their reports came (the first is as a rule the cause, the others
    its consequence in their next collective).  `timeout_s` bounds the whole
    call and the start-up's wait for the other ranks."""
    import torch.multiprocessing as mp

    if n_ranks < 1:
        raise ValueError(f"spawn: n_ranks must be >= 1, got {n_ranks}")
    if torch.device(device).type == "cuda":
        _need_card(device)
        from .. import _build

        _build.load_library()   # built once here; each rank then only loads it
    backend = backend_for(device, n_ranks)
    threads = max(1, (os.cpu_count() or 1) // n_ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pcs_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, backend, str(device),
                                   os.path.join(tmp, "rendezvous"), threads,
                                   timeout_s, fn, args, results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < n_ranks and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        # its report may still be on its way through the queue
                        try:
                            rank, ok, value = results.get(timeout=2.0)
                        except queue.Empty:
                            failure = (f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode} and no report")
                            continue
                    elif time.monotonic() > deadline:
                        failure = (f"no result from ranks "
                                   f"{sorted(set(range(n_ranks)) - set(out))} in "
                                   f"{timeout_s:g} s")
                        continue
                    else:
                        continue
                if ok:
                    out[rank] = value
                    continue
                failure = f"rank {rank} failed:\n{value}"
                # the reports of ranks that fell with it, if any follow at once
                grace = time.monotonic() + 1.0
                while time.monotonic() < grace:
                    try:
                        rank, ok, value = results.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if not ok:
                        failure += f"\nrank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30.0)
    if failure is not None:
        raise RuntimeError(f"parallel.spawn: {failure}")
    return [out[r] for r in range(n_ranks)]
