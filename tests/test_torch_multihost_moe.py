"""MoE training across hosts (models/moe.py's dispatch over the global
batch from a host's rows, `moe.HostDispatch`, models/train.py's batch
exchange) against the reference's step on the global mesh, on the CPU.

tiny-moe takes its expert capacity factor lowered to CAP on both sides,
so that every global microbatch drops assignments (its expert slots
are fewer than its assignments) and the prefix of the earlier hosts'
counts decides which.  Each layout runs as a gang of two host
processes over gloo (two gangs at once), each host on its CPU entries
and its stripe of every global batch, from the reference's initial
state, three steps:

- 'moe-data2': data 2, one entry a host (the unsharded state on a
  host);
- 'moe-data4-fsdp2-accum2': data 4 x fsdp 2 over two hosts of four
  entries, two accumulation microbatches (the reference's global row
  ranges);
- 'moe-pipeline2-hosts': pipeline 2 over two hosts at M = 2.

The reference is the jitted sharded step (`jit_train_step`) or, over a
pipeline, `pipeline_train_step`; tolerances are
tests/test_torch_multihost.py's.  A host run whose prefix is forced to
zero (patched in the host script, not in the package) is off the
reference by more than them, and under cfg.remat the exchange runs
once per (layer, microbatch) of a step, never again in the recompute.
A final norm moved on one host after the run shows in that host's
digest alone.
"""
from __future__ import annotations

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import train as jax_train
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import pipeline as jax_pipeline
from skypilot_tpu.parallel.sharding import token_batch_sharding
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import moe

import test_torch_multihost as multihost
import test_torch_multihost_pipeline as hosts_lib

B, S, STEPS = 16, 16, 3
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-6, 3e-5
CAP = 0.5
HOSTS = 2

# name -> (global MeshConfig kwargs, each host's CPU entries, accum_steps)
CASES = {
    'moe-data2': (dict(data=2), ['cpu'], 1),
    'moe-data4-fsdp2-accum2': (dict(data=4, fsdp=2), ['cpu'] * 4, 2),
    'moe-pipeline2-hosts': (dict(data=1, pipeline=2), ['cpu'], 2),
}
# Extra host runs against a case's reference: (case, fault, remat).
RUNS = {
    'zero-prefix': ('moe-data2', True, False),
    'remat-data2': ('moe-data2', False, True),
    'remat-pipeline2': ('moe-pipeline2-hosts', False, True),
}


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    return [{'tokens': rng.integers(0, 256, (B, S + 1)).astype(np.int32)}
            for _ in range(STEPS)]


def _reference(axes, accum, batches):
    """(initial state, [(loss, grad_norm)], flat final leaves) of the
    reference's jitted step on the global mesh at the capacity CAP."""
    jcfg = jax_configs.get_config('tiny-moe', expert_capacity_factor=CAP)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:n])
    if axes.get('pipeline', 1) > 1:
        jstate, shardings = jax_pipeline.create_pipeline_train_state(
            jcfg, jax_train.TrainConfig(), mesh=jmesh, batch_size=B,
            seq_len=S)
        jstep = jax.jit(jax_pipeline.pipeline_train_step(jcfg, jmesh, accum),
                        in_shardings=(shardings, None),
                        out_shardings=(shardings, None))
    else:
        jtcfg = jax_train.TrainConfig(accum_steps=accum)
        jstate, shardings = jax_train.create_train_state(
            jcfg, jtcfg, mesh=jmesh, batch_size=B, seq_len=S)
        jstep = jax_train.jit_train_step(shardings,
                                         token_batch_sharding(jmesh), jtcfg)
    init = multihost._reference_state(jstate)  # pylint: disable=protected-access
    metrics = []
    with jmesh:
        for batch in batches:
            jstate, jm = jstep(jstate, batch)
            metrics.append((float(jm['loss']), float(jm['grad_norm'])))
    cfg = configs.get_config('tiny-moe')
    return init, metrics, multihost._flat(  # pylint: disable=protected-access
        cfg, *multihost._reference_state(jstate)[:3])  # pylint: disable=protected-access


def _job(name, batches, init, zero_prefix=False, remat=False):
    axes, devices, accum = CASES[name]
    return dict(axes=axes, devices=devices, model='tiny-moe',
                layers=configs.get_config('tiny-moe').n_layers, m=accum,
                batches=batches, init=init,
                cfg=dict(expert_capacity_factor=CAP, remat=remat),
                zero_prefix=zero_prefix)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{run name: (reference metrics, reference leaves, [host results])}
    for every case and extra run: two gangs of two hosts, each running
    a case and the extra runs on it in turn, each as soon as its
    reference has written it."""
    root = str(tmp_path_factory.mktemp('multihost_moe'))
    path = lambda name: os.path.join(root, name)  # pylint: disable=unnecessary-lambda-assignment
    order = list(CASES) + list(RUNS)
    jobs = [[n for n in order if n == case or RUNS.get(n, ('',))[0] == case]
            for case in CASES]
    gangs = [hosts_lib._spawn(HOSTS, [path(n) for n in jobs[0]], root,  # pylint: disable=protected-access
                              'moe0'),
             hosts_lib._spawn(HOSTS, [path(n) for n in sum(jobs[1:], [])],  # pylint: disable=protected-access
                              root, 'moe1')]
    refs = {}
    try:
        batches = {name: _batches(51 + i) for i, name in enumerate(CASES)}
        with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
            futures = {pool.submit(_reference, CASES[n][0], CASES[n][2],
                                   batches[n]): n for n in CASES}
            for future in concurrent.futures.as_completed(futures):
                name = futures[future]
                init, metrics, leaves = future.result()
                hosts_lib._write(path(name), _job(name, batches[name], init))  # pylint: disable=protected-access
                refs[name] = (metrics, leaves, init)
        for run, (case, fault, remat) in RUNS.items():
            hosts_lib._write(path(run), _job(  # pylint: disable=protected-access
                case, batches[case], refs[case][2], zero_prefix=fault,
                remat=remat))
            refs[run] = refs[case]
        for gang in gangs:
            hosts_lib._finish(gang)  # pylint: disable=protected-access
    finally:
        for gang in gangs:
            multihost._kill(gang)  # pylint: disable=protected-access
    return {name: refs[name][:2] + (hosts_lib._results(path(name), HOSTS),)  # pylint: disable=protected-access
            for name in order}


def _off(want_metrics, want, got) -> bool:
    """Whether a host's results leave the tolerances anywhere."""
    try:
        np.testing.assert_allclose(got['metrics'], want_metrics, rtol=RTOL)
        for key, leaf in got['flat'].items():
            atol = ATOL if key.startswith(('mu/', 'nu/')) else PARAM_ATOL
            np.testing.assert_allclose(leaf, want[key], rtol=RTOL, atol=atol)
    except AssertionError:
        return True
    return False


def test_the_global_batch_drops_assignments():
    """At CAP every global microbatch has fewer expert slots than
    assignments, so some are dropped and the order decides which."""
    cfg = configs.get_config('tiny-moe', expert_capacity_factor=CAP)
    for _, _, accum in CASES.values():
        n = B * S // accum
        assert moe.capacity(cfg, n) * cfg.n_experts < n * cfg.expert_top_k


@pytest.mark.parametrize('name', list(CASES))
def test_moe_hosts_match_the_reference_on_the_global_mesh(runs, name):
    want_metrics, want, hosts = runs[name]
    hosts_lib._hold(name, want_metrics, want, hosts)  # pylint: disable=protected-access
    for got in hosts:
        assert got['step'] == STEPS


@pytest.mark.parametrize('name', list(CASES))
def test_a_drifted_host_changes_its_digest_alone(runs, name):
    hosts_lib._hold_drift(runs[name][2])  # pylint: disable=protected-access


def test_a_zero_prefix_is_caught(runs):
    """Host 1 dispatching as if its rows came first (every prefix zero)
    puts its rows into slots the reference gives host 0's: the run
    leaves the tolerances."""
    want_metrics, want, hosts = runs['zero-prefix']
    assert _off(want_metrics, want, hosts[1])


@pytest.mark.parametrize('run', ['remat-data2', 'remat-pipeline2'])
def test_the_remat_recompute_runs_no_second_exchange(runs, run):
    """Under cfg.remat every layer is recomputed in the backward; the
    step's exchange still all-gathers once per (layer, microbatch),
    and the run keeps the reference's numbers."""
    want_metrics, want, hosts = runs[run]
    case = RUNS[run][0]
    _, _, accum = CASES[case]
    cfg = configs.get_config('tiny-moe')
    stages = CASES[case][0].get('pipeline', 1)
    for got in hosts:
        assert got['gathers'] == [cfg.n_layers // stages * accum] * STEPS
    hosts_lib._hold(run, want_metrics, want, hosts)  # pylint: disable=protected-access


def _in_global_slots(buf, prefix, cap, axis):
    """A host's buffer (slot j of expert e at index j of `axis`) laid
    out in the global buffer's C slots: expert e's slot j at prefix_e +
    j; the slots past the global capacity must hold nothing."""
    shape = list(buf.shape)
    shape[axis] = cap
    out = buf.new_zeros(shape)
    for e, p in enumerate(prefix.tolist()):
        part = buf.select(axis - 1, e)
        room = max(0, min(part.shape[axis - 1], cap - p))
        assert not part.narrow(axis - 1, room,
                               part.shape[axis - 1] - room).any()
        if room:
            out.select(axis - 1, e).narrow(axis - 1, p, room).copy_(
                part.narrow(axis - 1, 0, room))
    return out


# The first part's rows: 24 leave every expert room for the second's,
# 40 fill them all.
@pytest.mark.parametrize('half', [24, 40])
def test_a_dispatch_over_halves_equals_the_whole_batch(half):
    """moe.dispatch over two halves of the rows, the first given a zero
    `prefix`, the second the first's counts, and both the whole's token
    count, takes the whole batch's combine weights row for row; each
    half's buffer holds its own kept slots only (fewer than the whole's
    C), and laid out in the global slots the halves' expert inputs fill
    disjoint slots of the whole's buffer."""
    cfg = configs.get_config('tiny-moe', expert_capacity_factor=CAP)
    gen = torch.Generator().manual_seed(7)
    n = 64
    tokens = torch.randn(n, cfg.d_model, generator=gen)
    logits = torch.randn(n, cfg.n_experts, generator=gen)
    whole_in, whole, _ = moe.dispatch(tokens, logits, cfg)
    cap = whole.shape[2]
    assert moe.dropped_tokens(logits, cfg) > 0
    zero = torch.zeros(cfg.n_experts, dtype=torch.int64)
    first_in, first, _ = moe.dispatch(tokens[:half], logits[:half], cfg,
                                      prefix=zero, n_global=n)
    _, _, gate_idx = moe.route(logits[:half], cfg.expert_top_k)
    counts = moe.expert_counts(gate_idx, cfg.n_experts)
    second_in, second, _ = moe.dispatch(
        tokens[half:], logits[half:], cfg, prefix=counts, n_global=n)
    assert second.shape[2] < cap and first.shape[2] <= cap
    assert torch.equal(torch.cat([
        _in_global_slots(first, zero, cap, 2),
        _in_global_slots(second, counts, cap, 2)]), whole)
    assert torch.equal(_in_global_slots(first_in, zero, cap, 1) +
                       _in_global_slots(second_in, counts, cap, 1), whole_in)
    # Without the prefix the second half takes the first half's slots.
    _, alone, _ = moe.dispatch(tokens[half:], logits[half:], cfg, n_global=n)
    assert not torch.equal(alone, whole[half:])
