"""The multi-process runtime on ``torch.distributed`` (port of
``lightgbm_tpu/parallel/distributed.py``; the reference's ``Network::Init``
and socket linkers, ``src/network/network.cpp:45-58``, and the
distributed bin finding of ``src/io/dataset_loader.cpp:824-1001``).

One process a rank, in one ``torch.distributed`` process group:

* **process bootstrap**: ``init_distributed`` resolves the machine list
  as the reference does (``machines=ip:port,...`` or
  ``machine_list_filename``, the local rank by a local interface address
  or ``LIGHTGBM_TPU_RANK`` / ``RANK``), or takes an explicit
  ``init_method`` (``tcp://host:port``, ``file:///path``), rank and world
  size, and calls ``init_process_group`` with a timeout (by default
  the elastic watchdog's bounds, ``robustness/elastic.py:
  watchdog_bounds_s``, of the given config or of the default params, and
  at least 60 s; an explicit timeout is raised to the config's bounds
  when a config is given), so that a lost
  rank fails a collective instead of hanging it. A failed rendezvous
  (the coordinator not up yet, a port still in TIME_WAIT) is retried
  with jittered backoff (``robustness/retry.py:retry_call``: 3 attempts
  from 1 s, ``LGBM_TPU_DIST_INIT_ATTEMPTS`` / ``LGBM_TPU_DIST_INIT_BACKOFF_S``),
  and a second SIGTERM that escalates leaves the group first
  (``robustness/preempt.py:register_escalation_cleanup``). The backend is ``nccl`` when every rank of the host can have a GPU
  of its own, ``gloo`` when ranks share a card or run on the CPU; the
  parallel learners use only collectives that gloo takes on CUDA tensors
  (``all_reduce``, ``all_gather``, ``broadcast``).
* **distributed bin finding**: with ``pre_partition=true`` every rank
  holds other rows, so the bin boundaries are agreed globally: each rank
  contributes its sample and ``gather_bin_sample`` gathers them in rank
  order, so every rank derives the same bin mappers (the reference
  gathers the mappers; gathering the bounded sample yields the same
  mappers everywhere, which is the invariant).

Without an initialised group (or in a group of one) every function here
is the single-process identity, and the parallel learners run a world of
one rank.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils.log import LightGBMError, log_info, log_warning

# the least seconds a collective (and the rendezvous) may wait for a
# lost rank when no timeout is given
DEFAULT_TIMEOUT_S = 60.0

# the group this process joined through init_distributed: its
# rendezvous (the elastic side-channel's address rule) and timeout
_GROUP = {"init_method": None, "timeout_s": None}


def parse_machines(config: Config) -> List[Tuple[str, int]]:
    """Machine list resolution (Config::Set + network.cpp:45-58):
    ``machine_list_filename`` (one ``ip port`` per line) takes
    precedence; else ``machines`` as ``ip:port,ip:port,...``."""
    out: List[Tuple[str, int]] = []
    if config.machine_list_filename:
        with open(config.machine_list_filename) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.replace(":", " ").split()
                if len(parts) < 2:
                    log_warning(f"Invalid machine list line: {line}")
                    continue
                out.append((parts[0], int(parts[1])))
    elif config.machines:
        for tok in config.machines.split(","):
            tok = tok.strip()
            if not tok:
                continue
            host, _, port = tok.partition(":")
            out.append((host, int(port) if port
                        else int(config.local_listen_port)))
    return out


def _local_addresses() -> set:
    addrs = {"localhost", "127.0.0.1"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        addrs.add(socket.gethostbyname(hostname))
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return addrs


def find_local_rank(machines: List[Tuple[str, int]],
                    config: Config) -> int:
    """This process's place in the machine list: the reference matches
    the local interfaces against it (linkers_socket.cpp:75-108); the
    environment (``LIGHTGBM_TPU_RANK``, or torch's ``RANK``) wins where
    interface addresses are unreliable."""
    for env in ("LIGHTGBM_TPU_RANK", "RANK"):
        if os.environ.get(env):
            return int(os.environ[env])
    local = _local_addresses()
    port = int(config.local_listen_port)
    candidates = [i for i, (host, p) in enumerate(machines)
                  if host in local]
    if len(candidates) == 1:
        return candidates[0]
    if len(candidates) > 1:
        # the same host several times: the listen port decides
        for i in candidates:
            if machines[i][1] == port:
                return i
        return candidates[0]
    mlist = ", ".join(f"[{i}] {h}:{p}"
                      for i, (h, p) in enumerate(machines))
    raise LightGBMError(
        "Could not locate this host in the machine list. "
        f"machines=({mlist}); local addresses="
        f"({', '.join(sorted(local))}); local_listen_port={port}. "
        "Set LIGHTGBM_TPU_RANK (or RANK) explicitly, or fix the machine "
        "list to name one of the local addresses.")


def default_backend(world_size: int) -> str:
    """``nccl`` when this host has a GPU for each rank, else ``gloo``
    (ranks that share a card, or CPU ranks)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(config: Optional[Config] = None, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """``Network::Init``: join the process group. Either an explicit
    ``init_method`` with ``rank`` and ``world_size``, or the config's
    machine list (rank 0's address is the rendezvous). Returns True when
    a group of more than one rank is up (idempotent), False for a single
    machine. With a config, syncs the bin-finding seed
    (``sync_bin_find_seed``)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None:
        machines = parse_machines(config) if config is not None else []
        if len(machines) < 2:
            return False
        init_method = f"tcp://{machines[0][0]}:{machines[0][1]}"
        world_size = len(machines)
        if rank is None:
            rank = find_local_rank(machines, config)
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs rank and world_size with "
                         "an init_method")
    backend = backend or default_backend(int(world_size))
    # not shorter than the watchdog's bounds, which lt.train holds the
    # group's timeout to
    from ..robustness.elastic import watchdog_bounds_s
    if timeout_s is None:
        timeout_s = max(DEFAULT_TIMEOUT_S, watchdog_bounds_s(
            config if config is not None else Config()))
    elif config is not None:
        timeout_s = max(float(timeout_s), watchdog_bounds_s(config))
    log_info(f"Initializing the process group: {world_size} ranks, "
             f"rank {rank}, {backend} at {init_method}")
    from ..robustness.retry import retry_call
    retry_call(
        dist.init_process_group, backend=backend, init_method=init_method,
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s),
        attempts=int(os.environ.get("LGBM_TPU_DIST_INIT_ATTEMPTS", 3)),
        base_delay_s=float(os.environ.get("LGBM_TPU_DIST_INIT_BACKOFF_S",
                                          1.0)),
        max_delay_s=30.0, retry_on=(RuntimeError, OSError),
        desc="torch.distributed.init_process_group")
    _GROUP.update(init_method=init_method, timeout_s=float(timeout_s))
    from ..robustness.preempt import register_escalation_cleanup
    register_escalation_cleanup(shutdown_distributed)
    if config is not None:
        sync_bin_find_seed(config)
    return dist.get_world_size() > 1


def group_rendezvous() -> Tuple[Optional[str], Optional[float]]:
    """(init_method, timeout_s) of the group this process joined through
    ``init_distributed``, or (None, None) (no group, or one made
    elsewhere)."""
    return _GROUP["init_method"], _GROUP["timeout_s"]


def group_store():
    """The process group's key-value store (None without a group)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


class WorldInfo(NamedTuple):
    """This process's place in the process group."""
    rank: int
    size: int


def current_world() -> Optional[WorldInfo]:
    """``WorldInfo(rank, size)`` in a group of more than one rank, else
    None (single-process runs, or before ``init_distributed``)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n <= 1:
        return None
    return WorldInfo(rank=dist.get_rank(), size=n)


def shutdown_distributed() -> None:
    """``Network::Dispose``: leave the process group. Idempotent."""
    import torch.distributed as dist
    try:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
            _GROUP.update(init_method=None, timeout_s=None)
            log_info("Process group shut down")
    except Exception as e:  # teardown is best-effort
        log_warning(f"destroy_process_group failed: {e}")


def _all_gather_host(arr: np.ndarray) -> List[np.ndarray]:
    """Every rank's host array (any shapes), in rank order."""
    import torch.distributed as dist
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(arr))
    return [np.asarray(a) for a in out]


def sync_bin_find_seed(config: Config) -> int:
    """``Network::GlobalSyncUpByMin(data_random_seed)``
    (application.cpp:96): cooperative bin finding
    (``is_parallel_find_bin``, the data and voting learners) needs every
    rank to draw the same sample, so the seed becomes the group's
    minimum. A no-op single-process or for the serial and feature
    learners."""
    if not config.is_parallel_find_bin or current_world() is None:
        return config.data_random_seed
    seeds = _all_gather_host(np.asarray([config.data_random_seed],
                                        np.int64))
    config.data_random_seed = int(min(int(s[0]) for s in seeds))
    return config.data_random_seed


def gather_rows(arr: np.ndarray) -> np.ndarray:
    """Every rank's rows of ``arr``, concatenated in rank order (the
    identity single-process)."""
    if current_world() is None:
        return arr
    return np.concatenate(_all_gather_host(arr))


def gather_bin_sample(sample: np.ndarray) -> np.ndarray:
    """Every rank's bin-finding sample rows, in rank order, so every
    rank derives the same bin mappers."""
    return gather_rows(sample)


def maybe_gather_bin_sample(sample: np.ndarray, config: Config,
                            num_data_local: int):
    """Distributed bin finding applies where ranks hold different rows
    (``pre_partition``) in a group. Returns ``(sample,
    num_data_global)``: the global row count scales sample-proportional
    thresholds (``feature_pre_filter``) as the reference scales them."""
    if not config.pre_partition or current_world() is None:
        return sample, num_data_local
    counts = _all_gather_host(np.asarray([num_data_local], np.int64))
    return gather_bin_sample(sample), int(sum(int(c[0]) for c in counts))


def maybe_gather_sparse_bin_sample(col_values: List[np.ndarray],
                                   sample_cnt: int, config: Config,
                                   num_data_local: int):
    """The sparse form of ``maybe_gather_bin_sample``: every rank's
    sampled non-zero values of each column, concatenated in rank order
    (the zeros ride the summed ``total_sample_cnt``). Returns
    ``(col_values, total_sample_cnt, num_data_global)``."""
    if not config.pre_partition or current_world() is None:
        return col_values, sample_cnt, num_data_local
    import torch.distributed as dist
    parts: List = [None] * dist.get_world_size()
    dist.all_gather_object(parts, ([np.asarray(c, np.float64)
                                    for c in col_values], int(sample_cnt),
                                   int(num_data_local)))
    merged = [np.concatenate([p[0][j] for p in parts])
              for j in range(len(col_values))]
    return (merged, sum(p[1] for p in parts), sum(p[2] for p in parts))
