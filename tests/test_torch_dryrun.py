"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's records in tests/fixtures/dryrun_cells.json (written by
tests/fixtures/capture_dryrun.py: `repro.launch.dryrun.lower_cell` /
`lower_bcpnn` compiled by XLA on 512 forced host devices).

The port's cells are built once, in a child process (the fake process
group of 512 ranks must not outlive them in a pytest worker): the JAX
test's own cell (xlstm-125m decode_32k on the multi-pod mesh), qwen2-1.5b
train_4k, prefill_32k and decode_32k on the single pod, and the rodent
tick at DRYRUN_N_HCU on 256 ranks. Held:

* ``memory.argument_bytes`` equal to XLA's ``argument_size_in_bytes``,
  exactly, for every LM cell; for the BCPNN tick, equal leaf by leaf but
  for the one listed difference, the key (`BCPNN_KEY_BYTES`): the port
  holds a threefry key as two uint32 words in int64 (16 bytes), the JAX
  package as uint32 (8);
* ``model_flops`` equal exactly;
* the BCPNN exchange's all-to-all bytes equal to the JAX record's (one
  (256, cap_route) int32 buffer a tick), and the exchange the only
  collective;
* every record complete (cost, collectives by kind, scan factor 1.0, a
  roofline). The flop and collective counts are printed beside JAX's,
  unchecked: the port counts its own unfused operations and DTensor's
  collectives, XLA its fused, scan-corrected program.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import roofline as RL

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "dryrun_cells.json"
LM_CELLS = (("xlstm-125m", "decode_32k", True),
            ("qwen2-1.5b", "train_4k", False),
            ("qwen2-1.5b", "prefill_32k", False),
            ("qwen2-1.5b", "decode_32k", False))
BCPNN_TAG = "bcpnn-rodent__tick_1ms__pod256-rodent"
BCPNN_KEY_BYTES = {"state.base_key": 16 - 8}

CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun as D
    cells = json.loads(sys.argv[1])
    out = {}
    with D.fake_world(512):
        for arch, shape, mp in cells:
            rec = D.lower_cell(arch, shape, multi_pod=mp)
            out[f"{arch}__{shape}__{rec['mesh']}"] = rec
    rec = D.lower_bcpnn("rodent", multi_pod=False)
    out[f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"] = rec
    print("RECORDS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def records():
    r = subprocess.run([sys.executable, "-c", CHILD, json.dumps(LM_CELLS)],
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):])


@pytest.fixture(scope="module")
def jax_records():
    return json.loads(FIXTURE.read_text())


def _tag(arch, shape, mp):
    return f"{arch}__{shape}__{'pod2x16x16' if mp else 'pod16x16'}"


@pytest.mark.parametrize("cell", LM_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_lm_cell_matches_xla(records, jax_records, cell):
    tag = _tag(*cell)
    got, want = records[tag], jax_records[tag]
    assert got["chips"] == want["chips"]
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"], got["memory"]
    assert got["model_flops"] == want["model_flops"]
    assert got["scan_factor"] == 1.0
    assert got["cost"]["flops"] > 0 and got["cost"]["bytes accessed"] > 0
    assert got["roofline"]["t_step_s"] > 0
    coll = got["collectives"]
    assert coll["total"] == pytest.approx(coll["nvlink"] + coll["nic"])
    print(f"\n{tag}: flops/rank {got['cost']['flops']:.4e} (XLA "
          f"{want['cost']['flops']:.4e}, scan-corrected "
          f"{want.get('cost_corrected', {}).get('flops', 0):.4e}); "
          f"collectives {coll['total']:.4e} B in {coll['counts']} (XLA "
          f"{want['collectives']['total']:.4e} B in "
          f"{want['collectives']['counts']}); temp "
          f"{got['memory'].get('temp_bytes')} (XLA "
          f"{want['memory']['temp_bytes']})")


def test_bcpnn_tick_matches_xla(records, jax_records):
    got, want = records[BCPNN_TAG], jax_records[BCPNN_TAG]
    for k in ("chips", "n_hcu", "h_local", "model_flops",
              "lazy_bytes_per_tick"):
        assert got[k] == want[k], k
    by_leaf = got["memory"]["argument_bytes_by_leaf"]
    assert got["memory"]["argument_bytes"] == sum(by_leaf.values())
    assert got["memory"]["argument_bytes"] - sum(BCPNN_KEY_BYTES.values()) \
        == want["memory"]["argument_bytes"]
    assert by_leaf["state.base_key"] == 16
    # the exchange: one (ranks, cap_route) int32 all-to-all, nothing else
    coll = got["collectives"]
    assert coll["all-to-all"] == want["collectives"]["all-to-all"]
    assert coll["counts"]["all-to-all"] == 1
    assert coll["total"] == coll["all-to-all"] == coll["nic"]
    assert coll["all-to-all"] == 256 * got["route"]["cap_route"] * 4
    assert got["roofline"]["peak"] == "float32"


def test_bcpnn_one_rank_counts_the_whole_network():
    """The count `chip_smoke.py` holds against the card's allocation:
    ``lower_bcpnn`` on one rank at the rodent preset's 32,000 HCUs (no
    process group needed)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_bcpnn
    p = get_config("bcpnn-rodent")
    rec = lower_bcpnn("rodent", multi_pod=False, n_hcu=p.n_hcu, ranks=1)
    leaf = rec["memory"]["argument_bytes_by_leaf"]
    cells = p.n_hcu * p.rows * p.cols
    for f in ("zij", "eij", "pij", "wij", "tij"):
        assert leaf[f"state.hcus.{f}"] == cells * 4
    assert leaf["conn.dest_hcu"] == p.n_hcu * p.cols * p.fanout * 4
    assert rec["h_local"] == p.n_hcu
    # the tick's bound: 1.05 GB of lazy traffic at 3.35 TB/s
    assert rec["roofline"]["t_step_s"] == pytest.approx(
        rec["lazy_bytes_per_tick"] / RL.HBM_BW)
