"""Data-parallel PPO over torch.distributed (counterpart of
learninghumanoidwalking_tpu/parallel/mesh.py's make_mesh and
shard_train_state).

One process a device: NCCL with ``cuda:<rank>`` on the card, gloo with the
CPU. The env batch is split into contiguous row blocks, ``num_envs / n`` a
rank; the networks, both Adam states and the observation norm are
replicated. In JAX, XLA keeps a sharded run equal to the one-device run of
the same global batch. Here that is written out (rl/ppo.py with a
``DataParallel``):

- every rank draws each per-env random number for the whole batch from the
  same seeded generator and keeps its rows (``RowDraws``), so its envs are
  the one-rank run's rows; draws that are not per env (the minibatch
  order) are the same on every rank;
- the advantage normalization, the running norm's batch moments and the
  metrics are global sums over ranks;
- each minibatch is the global one, of which a rank takes the rows it
  holds (maybe none); its loss is the local sum over the global minibatch
  size, so the all-reduced (summed) gradient is the global mean's and every
  rank applies the same update, the non-finite skip included;
- rank 0 alone evaluates, logs and writes checkpoints; the others wait.

``launch`` starts the ranks in spawned processes, rendezvous through a
FileStore in a fresh temporary directory.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from learninghumanoidwalking_tpu_torch.utils.seeding import Draws


def check_layout(num_envs: int, n_ranks: int, device_type: str) -> None:
    """Raise where ``num_envs`` envs cannot be split over ``n_ranks`` ranks
    of ``device_type``."""
    if n_ranks < 1 or num_envs % n_ranks != 0:
        raise ValueError(f"{num_envs} envs do not split evenly over {n_ranks} ranks")
    if device_type == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks asked for, but {torch.cuda.device_count()} CUDA device(s) are available")


@dataclasses.dataclass
class DataParallel:
    """This process's place in an initialized process group: rank ``rank``
    of ``world`` holds envs [lo, hi) of ``num_envs``. With ``timed``, every
    all-reduce is bracketed by device synchronizations and its seconds are
    added to ``reduce_seconds``."""

    rank: int
    world: int
    num_envs: int
    device: torch.device
    timed: bool = False
    reduce_seconds: float = 0.0

    @property
    def local_envs(self) -> int:
        return self.num_envs // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.local_envs

    @property
    def hi(self) -> int:
        return self.lo + self.local_envs

    def all_reduce(self, tensors) -> list:
        """The sums over ranks of float tensors, as new tensors of the same
        shapes (one all-reduce of one flat float32 buffer)."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        if self.timed:
            _synchronize(self.device)
            t0 = time.perf_counter()
        dist.all_reduce(flat)
        if self.timed:
            _synchronize(self.device)
            self.reduce_seconds += time.perf_counter() - t0
        out, start = [], 0
        for t in tensors:
            out.append(flat[start : start + t.numel()].reshape(t.shape).to(t.dtype))
            start += t.numel()
        return out

    def barrier(self) -> None:
        dist.barrier()

    def local_rows(self, global_rows: torch.Tensor) -> torch.Tensor:
        """The local indices of those of ``global_rows`` (env indices) that
        this rank holds, in their order."""
        keep = (global_rows >= self.lo) & (global_rows < self.hi)
        return global_rows[keep] - self.lo

    def local_samples(self, idx: torch.Tensor) -> torch.Tensor:
        """The local indices of those of the flat samples ``idx`` of a
        (time, num_envs) batch, time-major, that this rank holds (its
        (time, local_envs) rows), in their order."""
        t, env = idx // self.num_envs, idx % self.num_envs
        keep = (env >= self.lo) & (env < self.hi)
        return t[keep] * self.local_envs + env[keep] - self.lo

    def row_draws(self, draws: Draws) -> RowDraws:
        rows = torch.arange(self.lo, self.hi, device=self.device)
        return RowDraws(draws, rows, self.num_envs)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RowDraws(Draws):
    """The rows ``rows`` of every per-env draw of a ``num_envs`` batch
    from ``base``: each per-env draw (leading axis the envs) is taken for
    the whole batch and indexed, so ``base``'s stream advances as in a
    one-rank run; a permutation is not per env and passes through."""

    def __init__(self, base: Draws, rows: torch.Tensor, num_envs: int):
        self.base = base
        self.rows = rows
        self.num_envs = num_envs

    @property
    def gen(self):
        """The base's generator (checkpoints save and restore it)."""
        return getattr(self.base, "gen", None)

    def shifted(self, shift: int) -> RowDraws:
        """The rows of the batch rolled by ``shift`` (torch.roll's: row i
        takes row i - shift), as the trainer rotates its reset pool."""
        return RowDraws(self.base, (self.rows - shift) % self.num_envs, self.num_envs)

    def _global(self, shape) -> tuple:
        if shape[0] != len(self.rows):
            raise ValueError(f"a per-env draw of shape {tuple(shape)} for {len(self.rows)} envs")
        return (self.num_envs,) + tuple(shape[1:])

    def uniform(self, name, shape, lo, hi, device):
        return self.base.uniform(name, self._global(shape), lo, hi, device)[self.rows.to(device)]

    def randint(self, name, shape, lo, hi, device):
        return self.base.randint(name, self._global(shape), lo, hi, device)[self.rows.to(device)]

    def normal(self, name, shape, device):
        return self.base.normal(name, self._global(shape), device)[self.rows.to(device)]

    def choice(self, name, shape, values, p, device):
        return self.base.choice(name, self._global(shape), values, p, device)[self.rows.to(device)]

    def permutation(self, name, n, device):
        return self.base.permutation(name, n, device)


def init_rank(rank: int, world: int, device_type: str, store_path: str, num_envs: int) -> DataParallel:
    """Join the process group (NCCL on ``cuda:<rank>``, gloo on the CPU)
    through the FileStore at ``store_path``."""
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    return DataParallel(rank=rank, world=world, num_envs=num_envs, device=device)


def _rank_main(rank, world, device_type, num_envs, store_path, result_path, fn, args):
    if device_type == "cpu":  # share the host's cores between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    shard = init_rank(rank, world, device_type, store_path, num_envs)
    try:
        out = fn(shard, *args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, device_type: str, num_envs: int, *args):
    """Run ``fn(shard, *args)`` on ``n_ranks`` ranks, each a spawned process
    on its own device, and return rank 0's result. ``fn`` must be a
    module-level function (spawn pickles it by name) and its result
    picklable."""
    check_layout(num_envs, n_ranks, device_type)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lhw_ranks_") as tmp:
        store_path, result_path = os.path.join(tmp, "store"), os.path.join(tmp, "result.pt")
        mp.start_processes(_rank_main, args=(n_ranks, device_type, num_envs, store_path, result_path, fn, args),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return torch.load(result_path, weights_only=False)  # written by rank 0 above

