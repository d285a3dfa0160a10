"""Multi-node bring-up of the port against the JAX package's engine, on the
CPU.

Each node is a process of its own (this file run as a module, ``worker``),
as tests/test_multihost.py runs tests/multihost_worker.py: a fabric server
(the port's, ``python -m dynamo_tpu_torch.fabric.server``), then one
process per node, each ``build_torch_engine(multinode=MultiNodeConfig(...),
fabric=..., lease_id=...)`` from a worker thread. The nodes meet through
the fabric barrier, join one gloo grid, the leader serves through its
engine and every other node replays the step channel through its
``FollowerHandle``. The weights are the JAX init's in f32 (carried over
with ``params_from_jax`` and handed to every node in one file), so the bar
is the reference's: the greedy tokens of a single-device ``JaxEngine`` on
the same weights, exactly.

* two nodes as tp = 2, and again with the decode horizon 3 (every rank
  replays ``OP_DECODE_MULTI``);
* four nodes as dp x tp = 2 x 2;
* a leader killed after bring-up: its follower leaves (exit 3, "LEADER
  LOST") instead of waiting inside a collective, through the broken
  broadcast or the leader's expired barrier lease;
* ``MultiNodeConfig.from_env`` reads ``DYN_NUM_NODES`` / ``DYN_NODE_RANK`` /
  ``DYN_LEADER_ADDR``; without a fabric the nodes meet at a static
  ``leader_addr``; without either, bring-up raises.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [(list(range(2, 14)), 5), (list(range(3, 9)), 4)]
DIMS = dict(kv_block_size=4, max_batch=4, num_blocks=64, max_model_len=64)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cfg():
    from dynamo_tpu_torch.models import llama as tl

    return tl.LlamaConfig.tiny(vocab_size=64)


# ------------------------------------------------------------ the node


async def _serve_prompts(engine):
    from dynamo_tpu_torch.protocols import common as tp

    out = []
    for prompt, n in PROMPTS:
        req = tp.PreprocessedRequest(token_ids=prompt, sampling=tp.SamplingOptions(greedy=True),
                                     stop=tp.StopConditions(max_tokens=n, ignore_eos=True))
        toks = []
        async for o in engine.generate(req, tp.Context()):
            toks.extend(o.token_ids)
        out.append(toks)
    return out


async def _node(rank: int, nodes: int, tpn: int, dp: int, mode: str, params_path: str) -> None:
    import torch

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.fabric.client import FabricClient
    from dynamo_tpu_torch.parallel.multihost import FollowerHandle, LeaderLostError
    from dynamo_tpu_torch.parallel.multinode import MultiNodeConfig

    fabric = await FabricClient.connect(os.environ["DYN_FABRIC_ADDR"])
    ttl = float(os.environ.get("DYN_TEST_LEASE_TTL", "60"))
    lease = await fabric.lease_grant(ttl)

    async def keepalive() -> None:  # the bring-up lease lives as long as the node
        while True:
            await asyncio.sleep(max(0.5, ttl / 3))
            await fabric.lease_keepalive(lease)

    ka = asyncio.get_running_loop().create_task(keepalive())
    params = torch.load(params_path)
    built = await asyncio.get_running_loop().run_in_executor(None, lambda: build_torch_engine(
        _cfg(), device="cpu", dtype=torch.float32, params=params, tensor_parallel_size=tpn,
        data_parallel_size=dp, multinode=MultiNodeConfig(num_nodes=nodes, node_rank=rank),
        fabric=fabric, lease_id=lease, **DIMS))
    if rank != 0:
        assert isinstance(built, FollowerHandle)
        built.idle_grace_s = float(os.environ.get("DYN_TEST_IDLE_GRACE", "10"))
        try:
            await built.serve_async()
        except LeaderLostError as e:
            print(f"LEADER LOST: {e}", flush=True)
            os._exit(3)
        print("FOLLOWER DONE", flush=True)
    elif mode == "leader-hang":
        print("LEADER HANGING", flush=True)
        await asyncio.sleep(600)  # the test kills this process long before
    else:
        toks = await _serve_prompts(built)
        await built.close()
        stats = built.runner.final_stats
        print("TOKENS " + json.dumps(toks), flush=True)
        print("RANKS " + json.dumps(len(stats)), flush=True)
    ka.cancel()
    await fabric.close()


# ------------------------------------------------------------ the test side


def _reference_tokens(params_np) -> list:
    """A single-device JaxEngine's greedy tokens on the same weights."""
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.jax_engine.engine import JaxEngine, JaxEngineConfig
    from dynamo_tpu.engine.jax_engine.model_runner import ModelRunner
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.pipeline.context import Context
    from dynamo_tpu.protocols import common as jp

    cfg = jl.LlamaConfig.tiny(vocab_size=64)
    dims = dict(num_blocks=64, block_size=4, max_batch=4, max_model_len=64)
    runner = ModelRunner(cfg, jax.tree.map(jnp.asarray, params_np), kv_dtype=jnp.float32,
                         **dims)
    engine = JaxEngine(runner, JaxEngineConfig(**dims))

    async def run():
        out = []
        for prompt, n in PROMPTS:
            req = jp.PreprocessedRequest(
                token_ids=prompt, sampling=jp.SamplingOptions(greedy=True),
                stop=jp.StopConditions(max_tokens=n, ignore_eos=True))
            toks = []
            async for o in engine.generate(req, Context()):
                toks.extend(o.token_ids)
            out.append(toks)
        await engine.close()
        return out

    return asyncio.new_event_loop().run_until_complete(run())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(path of the port's params file, the JAX tokens on them)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dynamo_tpu.models import llama as jl
    from dynamo_tpu_torch.engine.torch_engine.weights import params_from_jax

    jparams = jl.init_params(jl.LlamaConfig.tiny(vocab_size=64), jax.random.PRNGKey(0),
                             jnp.float32)
    params_np = jax.tree.map(np.asarray, jparams)
    path = str(tmp_path_factory.mktemp("multinode") / "params.pt")
    torch.save(params_from_jax(params_np, device="cpu"), path)
    return path, _reference_tokens(params_np)


def _start(nodes, tpn, dp, params_path, env, mode="serve"):
    """The fabric server, then every node (the leader last)."""
    port = _free_port()
    env = {**os.environ, "DYN_FABRIC_ADDR": f"127.0.0.1:{port}", "PYTHONPATH": REPO, **env}
    server = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.fabric.server", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 30
    while time.time() < deadline:  # the server's port open
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            time.sleep(0.1)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multinode", "worker", str(rank), str(nodes),
         str(tpn), str(dp), mode, params_path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in reversed(range(nodes))]
    return server, procs[::-1]  # node order


def _stop(server, procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    server.kill()
    server.wait()


def _serve_nodes(nodes, tpn, dp, params_path, env=None):
    server, procs = _start(nodes, tpn, dp, params_path, env or {})
    try:
        out0, err0 = procs[0].communicate(timeout=240)
        assert procs[0].returncode == 0, f"leader failed:\n{err0[-3000:]}"
        for p in procs[1:]:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0 and "FOLLOWER DONE" in out, f"follower failed:\n{err[-3000:]}"
        lines = dict(line.split(" ", 1) for line in out0.splitlines() if " " in line)
        return json.loads(lines["TOKENS"]), json.loads(lines["RANKS"])
    finally:
        _stop(server, procs)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("horizon", [1, 3], ids=["single_step", "horizon3"])
def test_two_node_engine_serves_the_reference_tokens(weights, horizon):
    path, want = weights
    got, ranks = _serve_nodes(2, 2, 1, path, {"DYN_DECODE_HORIZON": str(horizon)})
    assert got == want and [len(t) for t in got] == [5, 4]
    assert ranks == 2


@pytest.mark.timeout(300)
def test_four_nodes_as_dp_by_tp_serve_the_reference_tokens(weights):
    path, want = weights
    got, ranks = _serve_nodes(4, 2, 2, path)
    assert got == want and ranks == 4


@pytest.mark.timeout(300)
def test_a_killed_leader_releases_its_follower(weights):
    path, _ = weights
    server, procs = _start(2, 2, 1, path, {"DYN_TEST_LEASE_TTL": "3",
                                           "DYN_TEST_IDLE_GRACE": "3"}, mode="leader-hang")
    leader, follower = procs
    try:
        deadline = time.time() + 180
        while time.time() < deadline:
            if leader.poll() is not None:
                pytest.fail(f"leader died during bring-up:\n{leader.stderr.read()[-3000:]}")
            if "LEADER HANGING" in leader.stdout.readline():
                break
        leader.kill()
        out, err = follower.communicate(timeout=60)
        assert follower.returncode == 3 and "LEADER LOST" in out, (follower.returncode, err[-3000:])
    finally:
        _stop(server, procs)


def test_the_config_reads_the_environment_and_static_mode_needs_an_address(monkeypatch):
    from dynamo_tpu_torch.parallel.multinode import (
        MultiNodeConfig,
        rendezvous_and_initialize,
        static_init_method,
    )

    monkeypatch.setenv("DYN_NUM_NODES", "4")
    monkeypatch.setenv("DYN_NODE_RANK", "2")
    monkeypatch.setenv("DYN_LEADER_ADDR", "10.0.0.5:29500")
    cfg = MultiNodeConfig.from_env()
    assert (cfg.num_nodes, cfg.node_rank, cfg.leader_addr, cfg.is_leader) == (
        4, 2, "10.0.0.5:29500", False)
    assert static_init_method(cfg) == "tcp://10.0.0.5:29500"
    assert asyncio.run(rendezvous_and_initialize(cfg)) == "tcp://10.0.0.5:29500"
    assert asyncio.run(rendezvous_and_initialize(MultiNodeConfig())) is None
    with pytest.raises(ValueError, match="needs a leader_addr"):
        static_init_method(MultiNodeConfig(num_nodes=2))


def test_the_grid_shape_follows_build_mesh_and_the_factory_checks_the_node_count():
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.parallel.mesh import AXES, grid_shape
    from dynamo_tpu_torch.parallel.multinode import MultiNodeConfig

    assert AXES == ("dp", "pp", "sp", "ep", "tp")  # build_mesh's order, tp innermost
    assert grid_shape(4) == (1, 1, 1, 1, 4)
    assert grid_shape(8, {"dp": 2, "ep": 2, "tp": 2}) == (2, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="mesh dp=1 pp=1 sp=2 ep=1 tp=2 needs 4 ranks, have 2"):
        grid_shape(2, {"sp": 2, "tp": 2})
    with pytest.raises(ValueError, match="unknown grid axes"):
        grid_shape(2, {"xp": 2})
    with pytest.raises(ValueError, match="a grid of 2 ranks .* over 4 nodes"):
        build_torch_engine(_cfg(), device="cpu", tensor_parallel_size=2,
                           multinode=MultiNodeConfig(num_nodes=4, node_rank=1,
                                                     leader_addr="127.0.0.1:1"))


def test_a_static_two_node_grid_serves_without_a_fabric(weights):
    """Static mode: both nodes given the same ``leader_addr`` and no
    fabric; the follower's ``serve()`` replays until the leader's engine
    closes."""
    path, want = weights
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    follower = subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multinode", "static", "1",
         f"127.0.0.1:{port}", path], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    leader = subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multinode", "static", "0",
         f"127.0.0.1:{port}", path], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out0, err0 = leader.communicate(timeout=240)
        out1, err1 = follower.communicate(timeout=60)
        assert leader.returncode == 0, err0[-3000:]
        assert follower.returncode == 0 and "FOLLOWER DONE" in out1, err1[-3000:]
        line = next(x for x in out0.splitlines() if x.startswith("TOKENS "))
        assert json.loads(line[len("TOKENS "):]) == want
    finally:
        for p in (leader, follower):
            if p.poll() is None:
                p.kill()


def _static_node(rank: int, addr: str, params_path: str) -> None:
    import torch

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.parallel.multinode import MultiNodeConfig

    built = build_torch_engine(
        _cfg(), device="cpu", dtype=torch.float32, params=torch.load(params_path),
        tensor_parallel_size=2,
        multinode=MultiNodeConfig(num_nodes=2, node_rank=rank, leader_addr=addr), **DIMS)
    if rank:
        built.serve()
        print("FOLLOWER DONE", flush=True)
        return
    toks = asyncio.run(_serve_and_close(built))
    print("TOKENS " + json.dumps(toks), flush=True)


async def _serve_and_close(engine):
    try:
        return await _serve_prompts(engine)
    finally:
        await engine.close()


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        r, n, t, d = (int(a) for a in sys.argv[2:6])
        asyncio.run(_node(r, n, t, d, sys.argv[6], sys.argv[7]))
    else:
        _static_node(int(sys.argv[2]), sys.argv[3], sys.argv[4])
