"""Where `align_reads_device` sends each read, pinned by counts on the CPU
at tiny sizes: for each branch of tests/test_torch_spans.py, a fixed call
on a dp = 2 mesh of CPU devices, `-P` calls (fixed and queued) and a call
outside the device engine's domain, the tier log (without its seconds),
the reads sent to the gold engine, retried and pre-routed, whether the
scan streamed, the launches with their work counters, and how often each
span was recorded.  The literals are those of the three orchestrations
before they shared one launch cycle, one gold-pool lifecycle and one set
of tier rules: a change to any of them shows here."""

import collections
import dataclasses

import pytest
import torch

from bwbble_tpu_torch import native as t_native
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine import pipeline
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import EngineConfig
from bwbble_tpu_torch.parallel.shard import make_mesh

from test_torch_fixed import pipe_world  # noqa: F401
from test_torch_pipeline import native_lib  # noqa: F401
from test_torch_precalc import pipe_pre  # noqa: F401
from test_torch_spans import BRANCHES, PARAMS, single_world  # noqa: F401

torch.set_num_threads(1)

COUNTERS = ("fallback_reads", "retried_reads", "prerouted", "streamed",
            "launches", "work_units", "pops", "rank_rows", "chain_work")

# route: (world, native library, d_cap, queued, params, arena cap, extra
# keywords); the branches of test_torch_spans.py at its settings
ROUTES = {b: (w, nat, d_cap, q, AlnParams(batch_size=batch, **PARAMS[w]),
              cap, {})
          for b, (w, nat, d_cap, q, batch, cap) in BRANCHES.items()}
ROUTES.update({
    # one launch of 160 reads split over two members, a deep tier of 256
    "mesh_dp2": ("mg", False, 16, False,
                 AlnParams(max_diff=2, batch_size=512), 256,
                 dict(mesh=(2, 1))),
    "seeded_fixed": ("pre", True, 32, False, None, 4096, {}),
    "seeded_queued": ("pre", True, 32, True, None, 4096, {}),
    # -o 7 lies outside the packed words: every read goes to gold
    "gold_routed": ("mg", True, 3, True,
                    AlnParams(max_diff=2, batch_size=128, n_threads=2,
                              max_gapo=7), 4096, {}),
})

EXPECTED = {
    'fixed_single':
    {'tiers': [{'B': 128, 'cap': 4096, 'reads': 150, 'failed': 0}],
     'fallback_reads': 0,
     'retried_reads': 0,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 16028,
     'pops': 9360,
     'rank_rows': 28136,
     'chain_work': 495,
     'spans': {'align': 1,
               'assemble': 2,
               'dbounds': 1,
               'dbounds.device': 1,
               'route': 1,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 1}},
    'fixed_single_deep':
    {'tiers': [{'B': 150, 'cap': 256, 'reads': 150, 'failed': 140},
               {'B': 140, 'cap': 131072, 'reads': 140, 'failed': 0}],
     'fallback_reads': 0,
     'retried_reads': 140,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 19952,
     'pops': 13140,
     'rank_rows': 35379,
     'chain_work': 371,
     'spans': {'align': 1,
               'assemble': 2,
               'dbounds': 1,
               'dbounds.device': 1,
               'route': 1,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 2}},
    'gold_routed':
    {'tiers': [],
     'fallback_reads': 160,
     'retried_reads': 0,
     'prerouted': None,
     'streamed': None,
     'launches': None,
     'work_units': None,
     'pops': None,
     'rank_rows': None,
     'chain_work': None,
     'spans': {'align': 1, 'gold.drain': 1}},
    'mesh_dp2':
    {'tiers': [{'B': 160, 'cap': 256, 'reads': 160, 'failed': 157},
               {'B': 157, 'cap': 131072, 'reads': 157, 'failed': 0}],
     'fallback_reads': 0,
     'retried_reads': 157,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 31017,
     'pops': 19813,
     'rank_rows': 59652,
     'chain_work': 649,
     'spans': {'align': 1,
               'assemble': 2,
               'dbounds': 1,
               'dbounds.device': 1,
               'dbounds.probe': 1,
               'route': 1,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 2}},
    'queued_deep':
    {'tiers': [{'B': 144,
                'cap': 4096,
                'reads': 160,
                'failed': 22,
                'work': 24029},
               {'B': 128,
                'cap': 262144,
                'reads': 22,
                'failed': 0,
                'work': 9160}],
     'fallback_reads': 0,
     'retried_reads': 22,
     'prerouted': 0,
     'streamed': None,
     'launches': 3,
     'work_units': 33189,
     'pops': 22137,
     'rank_rows': 64579,
     'chain_work': 1026,
     'spans': {'align': 1,
               'assemble': 2,
               'dbounds': 1,
               'dbounds.native': 2,
               'dbounds.probe': 1,
               'dbounds.scan': 4,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 1,
               'search.collect': 3,
               'search.dispatch': 3,
               'tier': 2}},
    'queued_escalation':
    {'tiers': [{'B': 128,
                'cap': 4096,
                'reads': 160,
                'failed': 22,
                'work': 24029}],
     'fallback_reads': 22,
     'retried_reads': 0,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 24029,
     'pops': 15124,
     'rank_rows': 48038,
     'chain_work': 408,
     'spans': {'align': 1,
               'assemble': 1,
               'dbounds': 1,
               'dbounds.device': 1,
               'dbounds.native': 1,
               'dbounds.probe': 1,
               'dbounds.scan': 1,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 2,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 1}},
    'queued_probe_skip':
    {'tiers': [{'B': 128,
                'cap': 4096,
                'reads': 160,
                'failed': 22,
                'work': 24029}],
     'fallback_reads': 22,
     'retried_reads': 0,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 24029,
     'pops': 15124,
     'rank_rows': 48038,
     'chain_work': 408,
     'spans': {'align': 1,
               'assemble': 1,
               'dbounds': 1,
               'dbounds.native': 2,
               'dbounds.probe': 1,
               'dbounds.scan': 4,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 2,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 1}},
    'seeded_fixed':
    {'tiers': [{'B': 128, 'cap': 4096, 'reads': 157, 'failed': 9}],
     'fallback_reads': 12,
     'retried_reads': 0,
     'prerouted': 3,
     'streamed': None,
     'launches': 2,
     'work_units': 7467,
     'pops': 5644,
     'rank_rows': 12976,
     'chain_work': 303,
     'spans': {'align': 1,
               'assemble': 2,
               'dbounds': 1,
               'dbounds.device': 1,
               'dbounds.probe': 1,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 4,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 1}},
    'seeded_queued':
    {'tiers': [{'B': 128,
                'cap': 4096,
                'reads': 160,
                'failed': 9,
                'work': 7603}],
     'fallback_reads': 9,
     'retried_reads': 0,
     'prerouted': 0,
     'streamed': None,
     'launches': 2,
     'work_units': 7603,
     'pops': 5754,
     'rank_rows': 13204,
     'chain_work': 303,
     'spans': {'align': 1,
               'assemble': 1,
               'dbounds': 1,
               'dbounds.device': 1,
               'dbounds.probe': 1,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 2,
               'search.collect': 2,
               'search.dispatch': 2,
               'tier': 1}},
    'streamed':
    {'tiers': [{'B': 128, 'cap': 4096, 'reads': 157, 'failed': 22},
               {'B': 256, 'cap': 131072, 'reads': 18, 'failed': 0}],
     'fallback_reads': 7,
     'retried_reads': 18,
     'prerouted': 3,
     'streamed': True,
     'launches': 3,
     'work_units': 30678,
     'pops': 20450,
     'rank_rows': 59770,
     'chain_work': 1046,
     'spans': {'align': 1,
               'assemble': 3,
               'dbounds': 4,
               'dbounds.native': 2,
               'dbounds.probe': 1,
               'dbounds.scan': 4,
               'gold.drain': 1,
               'gold.start': 1,
               'route': 2,
               'search.collect': 3,
               'search.dispatch': 3,
               'tier': 2}},
}


@pytest.fixture
def route_run(pipe_world, single_world, pipe_pre, native_lib,  # noqa: F811
              monkeypatch):
    def run(route):
        world, native, d_cap, queued, params, cap, kw = ROUTES[route]
        w = {"mg": pipe_world, "single": single_world,
             "pre": pipe_pre}[world]
        monkeypatch.setattr(t_native, "_native", native_lib if native
                            else None)
        monkeypatch.setattr(t_native, "_tried", True)
        kw = dict(kw)
        if "mesh" in kw:
            kw["mesh"] = make_mesh(*kw["mesh"],
                                   devices=[torch.device("cpu")] * 8)
        if world == "pre":
            params = dataclasses.replace(w["params"], n_threads=2)
            kw.update(precalc=w["table"], seed_slots=2)
        stats: dict = {}
        pipeline.align_reads_device(
            w["idx"], from_fmindex(w["idx"], device="cpu"), w["reads"],
            params, EngineConfig(cap=cap, acap=24), d_cap=d_cap,
            queued=queued, qchunk=1, stats=stats, device="cpu", **kw)
        return stats
    return run


def observed(stats: dict) -> dict:
    return dict(
        tiers=[{k: v for k, v in t.items() if k != "sec"}
               for t in stats.get("tiers", [])],
        **{k: stats.get(k) for k in COUNTERS},
        spans=dict(sorted(collections.Counter(
            s["name"] for s in stats["spans"]).items())))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_counts(route_run, route):
    assert observed(route_run(route)) == EXPECTED[route]
