"""The port's examples (examples/*_torch.py) run end to end on the CPU, in
subprocesses, at small sizes, each ending in its OK line; the quickstart's
spike and drop counts equal the JAX example's (examples/quickstart.py, run
in a child process through `tests/torch_jax_ref.run_jax`, which applies
the import shim), and the port's examples import no JAX."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from torch_jax_ref import run_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart_torch": ([], "OK — lazy BCPNN network ran and stayed "
                             "consistent."),
    "bcpnn_assoc_memory_torch": (["--reps", "10"],
                                 "OK — associative recall well above "
                                 "chance."),
    "serve_lm_torch": ([], "OK — engine output matches the reference "
                           "decode path."),
    "serve_lm_torch_flash": (["--attn", "pallas_flash", "--prompt-len",
                              "128", "--max-new", "8"],
                             "OK — engine output matches the reference "
                             "decode path."),
    "train_lm_torch": (["--steps", "20", "--batch", "4", "--seq", "32"],
                       "OK — training reduced the loss."),
}


def run_example(name, args):
    script = ROOT / "examples" / (name.replace("_flash", "") + ".py")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(script), "--device", "cpu",
                        *args], capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_to_its_ok_line(name):
    args, ok = EXAMPLES[name]
    assert run_example(name, args).rstrip().splitlines()[-1] == ok


def test_examples_import_no_jax():
    for f in (ROOT / "examples").glob("*_torch.py"):
        src = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src,
                             re.M), f.name


def test_quickstart_counts_match_jax():
    body = (ROOT / "examples" / "quickstart.py").read_text()
    body = body.split('"""', 2)[2] + (
        "\nOUT['counts'] = np.asarray([int(sim.state.t), fired_total, "
        "int(sim.state.drops_in), int(sim.state.drops_fire)])\n")
    want = run_jax(body, timeout=300)["counts"].tolist()
    out = run_example("quickstart_torch", [])
    got = [int(re.search(rf"{k}\s*: (\d+)", out).group(1)) for k in
           ("ticks simulated", "output spikes fired", "input-queue drops",
            "fire-batch drops")]
    assert got == want
