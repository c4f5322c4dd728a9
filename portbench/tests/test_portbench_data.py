"""A configuration, a traffic mix and a per-layer metric are added as
files and BENCHMARK.json entries, and a run finds them, with no other
file edited; so are the program's settings that no committed cell uses
yet: the int64 index layout, the `-P` seed table, and a mesh of the
cell's chips."""

import hashlib
import json
import os
import shutil

import pytest

from portbench.tests.helpers import TINY_MG, TINY_SINGLE, add_to_metric, \
    make_checkout, run_cpu


def _hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        if ".cache" in d or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _add_cell(ck, config, traffic, chips=1, metric="reads_per_s"):
    """The config and traffic files, a workloads entry and the cell listed
    under the end-to-end `metric`; the paths of the files that changed."""
    pb = os.path.join(ck, "portbench")
    before = _hashes(ck)
    with open(os.path.join(pb, "configs", config["name"] + ".json"),
              "w") as f:
        json.dump(config, f)
    if traffic is not None:
        with open(os.path.join(pb, "traffic", traffic["name"] + ".json"),
                  "w") as f:
            json.dump(traffic, f)
    bench_path = os.path.join(ck, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    name = config["name"] + "." + (traffic or {"name": "wgsim"})["name"]
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": name.split(".", 1)[1],
                               "chips": chips, "why": "test"})
    add_to_metric(bench, metric, [name])
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    after = _hashes(ck)
    return name, sorted(p for p in before if before[p] != after.get(p))


def test_new_files_are_found_by_name(tmp_path):
    ck = make_checkout(str(tmp_path))
    cfg = dict(TINY_SINGLE, name="tiny_single_b", reads_per_call=32)
    cfg["world"] = dict(cfg["world"], genome_seed=12)
    traffic = {"name": "wgsim80", "read_len": 80, "error_rate": 0.01,
               "reverse_share": 0.5,
               "donor": {"vcf_sample": "S2", "mut_rate": 0.002,
                         "indel_frac": 0.2, "indel_extend": 0.3, "seed": 4}}
    with open(os.path.join(ck, "portbench", "metrics",
                           "calls_in_window.py"), "w") as f:
        f.write('UNIT = "calls"\nLAYER = "entry and formats"\n'
                'SOURCE = "host_clock"\nMOVES = "reads_per_s"\n\n\n'
                'def read(run):\n    return float(len(run.calls))\n')
    bench_path = os.path.join(ck, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "entry and formats",
        "moves": "reads_per_s"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    name, edited = _add_cell(ck, cfg, traffic)
    assert edited == ["BENCHMARK.json"]
    info, res, _ = run_cpu(ck, name, seed=4, trace=True)
    assert res["correct"] is True
    assert res["metrics"]["calls_in_window"] == {
        "value": float(info["calls"]), "unit": "calls"}
    shutil.rmtree(ck)


def test_metrics_follow_the_cells_end_to_end_time(tmp_path):
    """A cell listed under `card_ms_per_kread` in place of `reads_per_s`
    reports the per-layer metrics that move the card's time, and the
    window's reads a second among them."""
    ck = make_checkout(str(tmp_path))
    cfg = dict(TINY_MG, name="tiny_mg_card")
    name, edited = _add_cell(ck, cfg, None, metric="card_ms_per_kread")
    assert edited == ["BENCHMARK.json"]
    info, res, _ = run_cpu(ck, name, seed=2**31 + 5)
    # no card: the card's time has nothing to read, and is left out
    assert res["correct"] is True and set(res["metrics"]) == {"setup_s"}
    info, res, _ = run_cpu(ck, name, seed=2**31 + 5, trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {
        "window_reads_per_s", "io_ms_per_kread.card",
        "dbound_ms_per_kread.card", "gold_routed_pct.card",
        "search_ms_per_kread.card", "host_ms_per_kread.card"}
    assert res["metrics"]["window_reads_per_s"] == {
        "value": info["reads"] / info["window_s"], "unit": "reads/s"}
    shutil.rmtree(ck)


SETTINGS = {
    # the int64 layout of the index, on a mesh of two devices (dp 2)
    "int64_mesh": (TINY_MG, {"index": {"use_int64": True}}, 2),
    # tp 2: the index range-sharded over the two devices of the mesh
    "tp_mesh": (TINY_SINGLE, {"tp": 2}, 2),
    # -P: the program's seed table, built into the world's directory
    "precalc": (TINY_SINGLE, {"params": dict(TINY_SINGLE["align"]["params"],
                                             use_precalc=True,
                                             precalc_len=6)}, 1),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_program_settings_are_data(tmp_path, setting):
    base, align, chips = SETTINGS[setting]
    ck = make_checkout(str(tmp_path))
    cfg = dict(base, name=f"{base['name']}_{setting}")
    cfg["align"] = dict(base["align"], **align)
    name, edited = _add_cell(ck, cfg, None, chips=chips)
    assert edited == ["BENCHMARK.json"]
    info, res, forbidden = run_cpu(ck, name, seed=2**31 + 21)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["count"] == chips
    assert info["checked_reads"] == info["reads"] > 0
    assert forbidden == []
    if setting == "precalc":
        assert "precalc_s" in info["cold_setup"]
        again, res2, _ = run_cpu(ck, name, seed=5)
        assert "precalc_s" not in again["cold_setup"]
        assert res2["correct"] is True
    shutil.rmtree(ck)
