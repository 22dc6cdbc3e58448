"""A group of CPU ranks over gloo for the port's multi-process tests, and
the work those ranks do. Imports no JAX: the ranks never run it.

`RankGroup(world)` starts `world` processes of this file, each joined to a
gloo process group (with a timeout) and to the parent by a local
connection; `group.run(task, *args, timeout=...)` hands every rank the
same call of one of this module's functions and returns their results
in rank order (`run_while` computes the parent's reference meanwhile). A rank that raises fails the call with its traceback; a
call that overruns its timeout kills the ranks and fails. A test module
makes one group (a module-scoped fixture) and runs all its collective
work there.
"""

import os
import secrets
import subprocess
import sys
import tempfile
import traceback
from multiprocessing.connection import Client, Listener

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# seconds a rank's collectives wait for the others before raising
PG_TIMEOUT_S = 120


class RankGroup:
    """`world` gloo ranks on the CPU, started at construction."""

    def __init__(self, world: int = 2, start_timeout: float = 60.0):
        self.world = world
        self.key = secrets.token_bytes(16)
        self.listener = Listener(("localhost", 0), authkey=self.key)
        self.log = tempfile.NamedTemporaryFile("w+", prefix="ranks_",
                                               suffix=".log", delete=False)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, HERE, os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        host, lport = self.listener.address
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(world), f"{host}:{lport}", self.key.hex()],
            env=env, stdout=self.log, stderr=subprocess.STDOUT)
            for rank in range(world)]
        self.conns = [None] * world
        self.listener._listener._socket.settimeout(start_timeout)
        try:
            for _ in range(world):
                conn = self.listener.accept()
                self.conns[conn.recv()] = conn
            # rank 0's store listens on a port the system gave it (no port
            # chosen here and bound later, which another process can take
            # between the two); the other ranks meet it there
            if not self.conns[0].poll(start_timeout):
                raise OSError("rank 0 sent no store port")
            port = self.conns[0].recv()
            for conn in self.conns[1:]:
                conn.send(port)
        except OSError:
            self.close()
            raise AssertionError("the ranks did not connect within "
                                 f"{start_timeout} s:\n{self.output()}")

    def output(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-6000:]

    def run(self, task, *args, timeout: float = 60.0, **kwargs):
        """[task(*args, **kwargs) on each rank], in rank order."""
        return self.run_while(None, task, *args, timeout=timeout,
                              **kwargs)[0]

    def run_while(self, work, task, *args, timeout: float = 60.0,
                  **kwargs):
        """(`run`'s results, work()): `work` (None: nothing) runs here
        while the ranks run the task; the ranks' results are read even
        when `work` raises."""
        for conn in self.conns:
            conn.send((task.__name__, args, kwargs))
        try:
            mine = work() if work is not None else None
        finally:
            theirs = self._collect(task.__name__, timeout)
        return theirs, mine

    def _collect(self, name: str, timeout: float):
        results = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(timeout):
                self.close()
                raise AssertionError(f"rank {rank} overran {timeout} s in "
                                     f"{name}:\n{self.output()}")
            ok, value = conn.recv()
            if not ok:
                raise AssertionError(f"rank {rank} raised in {name}:\n"
                                     f"{value}")
            results.append(value)
        return results

    def close(self, timeout: float = 20.0):
        """Stop the ranks; kill any that have not ended within
        `timeout`."""
        for conn in self.conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.listener.close()
        self.log.close()
        os.unlink(self.log.name)


def _serve(rank: int, world: int, parent: str, key: str):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    host, lport = parent.rsplit(":", 1)
    conn = Client((host, int(lport)), authkey=bytes.fromhex(key))
    conn.send(rank)
    timeout = timedelta(seconds=PG_TIMEOUT_S)
    if rank == 0:  # the store binds port 0: the system picks a free one
        store = dist.TCPStore("localhost", 0, world, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        conn.send(store.port)
    else:
        store = dist.TCPStore("localhost", conn.recv(), world,
                              is_master=False, timeout=timeout)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(store.port))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timeout)
    this = sys.modules[__name__]
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            conn.send((True, getattr(this, name)(*args, **kwargs)))
        except BaseException:  # reported to the parent, which fails
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the ranks' work
# ---------------------------------------------------------------------------


def port_model(name: str, seed: int = 0, **overrides):
    """The small port model `_torch_port.port_small(seed, name)` builds
    (init_weights, then He scale), without JAX; `overrides` change the
    registry config."""
    import torch

    from _torch_configs import CONFIGS
    from _torch_scale import he_scale
    from stf_tpu_torch.models import init_weights
    from stf_tpu_torch.zoo import models

    gen = torch.Generator().manual_seed(seed)
    port = init_weights(models[name](**{**CONFIGS[name], **overrides}), gen)
    return he_scale(port, gen, name)


def local(t):
    """A tensor as NumPy: a plain one whole, a sharded one (a `DTensor`
    of a `fully_shard`ed model) as ("shard", this rank's dim-0 shard),
    which `whole` joins with the other ranks'. No collective."""
    if hasattr(t, "to_local"):
        return ("shard", t.to_local().detach().numpy().copy())
    return t.detach().numpy().copy()


def local_state(model):
    """The model's state_dict, each entry `local`."""
    return {k: local(v) for k, v in model.state_dict().items()}


def whole(per_rank):
    """One {name: array} from every rank's dict of `local` entries: the
    shards joined on dim 0 in rank order, and a whole entry rank 0's,
    after checking every rank holds the same."""
    import numpy as np

    out = {}
    for k, v in per_rank[0].items():
        if isinstance(v, tuple):
            out[k] = np.concatenate([r[k][1] for r in per_rank])
            continue
        for r in per_rank[1:]:
            np.testing.assert_array_equal(r[k], v, err_msg=k)
        out[k] = v
    return out


def mesh_shape(batch_size, model=1):
    """create_mesh's dim names and sizes, or its error message."""
    from stf_tpu_torch.parallel import create_mesh

    try:
        mesh = create_mesh(batch_size=batch_size, model=model,
                           device_type="cpu")
    except ValueError as e:
        return str(e)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def first_moments(state):
    """{parameter name: Adam's first moment} of both optimizers, each
    `local`. After the first update it is (1 - beta1) x the averaged,
    clipped gradient: unlike the parameter, which that update moves by
    about lr x sign(g), it carries the gradient's size."""
    out = {}
    for name, p in state.model.named_parameters():
        opt = (state.optimizer if p in state.optimizer.state
               else state.aux_optimizer)
        out[name] = local(opt.state[p]["exp_avg"])
    return out


def parallel_steps(name: str, x, lmbda: float, tp: int = 1, steps: int = 1,
                   seed: int = 0, config=None, root=None, best=False):
    """`steps` parallel train steps of the small `name` model on this
    rank's rows of the global NHWC batch `x` (NumPy), DDP or with --tp
    `tp`: {"metrics": [of each step], "params": [`local_state` after each
    step], "moments": `first_moments` after the first step, "sharded":
    the number of sharded parameters}. `config` overrides the model's
    small config. With `root`, then a collective save in `root` (as
    best too with `best`), restored into a fresh model, mesh and
    TrainState: "round_trip" = (the saved and restored states agree bit
    for bit, the meta, {sidecar file: its state_dict} (rank 0), the
    restored `local_state`)."""
    import torch

    from stf_tpu_torch.parallel import (
        create_mesh,
        data_parallel_shardings,
        make_parallel_train_step,
        parallelize,
        shard_batch,
    )
    from stf_tpu_torch.training import TrainState, make_train_step

    def build(seed):
        mesh = create_mesh(batch_size=len(x), model=tp, device_type="cpu")
        model = port_model(name, seed, **(config or {}))
        forward = parallelize(model, mesh)
        state = TrainState(model, "cpu", seed=11 + seed,
                           shard=data_parallel_shardings(mesh))
        return mesh, forward, state

    mesh, forward, state = build(seed)
    step = make_parallel_train_step(make_train_step(forward, lmbda))
    batch = shard_batch(torch.from_numpy(x), mesh)
    out = {"metrics": [], "params": []}
    for _ in range(steps):
        out["metrics"].append({k: float(v) for k, v
                               in step(state, batch).items()})
        out["params"].append(local_state(state.model))
        out.setdefault("moments", first_moments(state))
    out["sharded"] = sum(type(p).__name__ == "DTensor"
                         for p in state.model.parameters())
    if root is not None:
        out["round_trip"] = _round_trip(state, name, lmbda, root, best,
                                        build(seed + 1)[2])
    return out


def _round_trip(state, name, lmbda, root, best, fresh):
    """`state` saved in `root` and restored into `fresh` (see
    `parallel_steps`)."""
    import torch

    from stf_tpu_torch.parallel import is_main_process
    from stf_tpu_torch.training.checkpoint import (
        ShardedCheckpointer,
        _train_state,
    )

    ckpt = ShardedCheckpointer(root)
    meta = {"model": name, "lmbda": lmbda, "metric": "mse"}
    ckpt.save(state, 3, 1.5, meta, best, 1.25)
    ckpt.close()
    got = ShardedCheckpointer(root, read_only=True).restore(fresh)
    equal = _same(_train_state(state), _train_state(fresh))
    equal = equal and fresh.step == state.step
    sidecars = {}
    if is_main_process():
        for f in sorted(os.listdir(root)):
            if f.endswith(".pth.tar"):
                sidecars[f] = {k: v.numpy() for k, v in
                               torch.load(os.path.join(root, f)).items()}
    return equal, got, sidecars, local_state(fresh.model)


def _same(a, b) -> bool:
    """Nested dicts / lists of tensors (sharded ones compared by their
    local shards) and plain values, equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        la = a.to_local() if hasattr(a, "to_local") else a
        lb = b.to_local() if hasattr(b, "to_local") else b
        return la.shape == lb.shape and torch.equal(la, lb)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return a == b


def run_cli(module: str, argv, models=None):
    """`stf_tpu_torch.training.<module>.main(argv)` on every rank, with
    test-only registry entries `models` ({name: (registry name, config
    overrides)}): (standard output, SystemExit message or None, the
    returned state's step)."""
    import contextlib
    import importlib
    import io

    from _torch_configs import CONFIGS
    from stf_tpu_torch.zoo import registry

    cli = importlib.import_module(f"stf_tpu_torch.training.{module}")
    old = dict(registry.models)
    registry.models.update({
        name: _Small(base, {**CONFIGS[base], **cfg})
        for name, (base, cfg) in (models or {}).items()})
    out, exit_msg, step = io.StringIO(), None, None
    try:
        with contextlib.redirect_stdout(out):
            state = cli.main(list(argv))
        step = state.step
    except SystemExit as e:
        exit_msg = str(e)
    finally:
        registry.models.clear()
        registry.models.update(old)
    return out.getvalue(), exit_msg, step


class _Small:
    """A registry entry building `base` at a small config."""

    def __init__(self, base, cfg):
        self.base, self.cfg = base, cfg

    def __call__(self, **kw):
        from stf_tpu_torch.zoo import registry

        return registry.models[self.base](**{**self.cfg, **kw})


def dytrain_steps(x, lmbda: float, keep, steps: int = 1):
    """`steps` data-parallel distillation steps (clf_weight 1) of the small
    DYSTF against its STF teacher (`distill_pair`) on this rank's rows of
    `x`: ([parts of each step], the student's `local_state`, its
    `first_moments` after the first step)."""
    import torch

    from stf_tpu_torch.parallel import (
        create_mesh,
        data_parallel_shardings,
        make_parallel_train_step,
        parallelize,
        shard_batch,
    )
    from stf_tpu_torch.training import TrainState, make_dytrain_step

    mesh = create_mesh(batch_size=len(x), device_type="cpu")
    student, teacher = distill_pair()
    forward = parallelize(student, mesh)
    state = TrainState(student, "cpu", seed=11,
                       shard=data_parallel_shardings(mesh))
    step = make_parallel_train_step(make_dytrain_step(
        forward, teacher, lmbda, keep, clf_weight=1.0))
    batch = shard_batch(torch.from_numpy(x), mesh)
    history, moments = [], None
    for _ in range(steps):
        history.append({k: float(v) for k, v in step(state, batch).items()})
        moments = moments or first_moments(state)
    return history, local_state(student), moments


def distill_pair():
    """(the small DYSTF student, its small STF teacher with is_teacher) at
    `tests/test_torch_dytrain.py`'s weights: seeds 6 and 4, He scale."""
    import torch

    from _torch_configs import DYSTF_TRAIN, STF_SMALL
    from _torch_scale import he_scale
    from stf_tpu_torch.models import DYSTF, SymmetricalTransFormer, init_weights

    def small(cls, config, name, seed):
        gen = torch.Generator().manual_seed(seed)
        return he_scale(init_weights(cls(**config), gen), gen, name)

    student = small(DYSTF, DYSTF_TRAIN, "dystf", 6)
    teacher = small(SymmetricalTransFormer, STF_SMALL, "stf", 4)
    teacher.is_teacher = True
    return student, teacher


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
