"""What the benchmark loads: no run loads JAX, the JAX package or its
reference (top-level names compared whole, so ``gymgo_tpu_torch`` is not
``gymgo_tpu``), and the plain reference loads nothing of the program."""

import json
import subprocess
import sys

from portbench import harness

_LOADED = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"{code}\n{_LOADED}"], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_drivers_readers_and_faults_load_no_jax():
    code = "\n".join([
        "from portbench import harness, faults, controls",
        "bench = harness.manifest()",
        "for w in bench['workloads']:",
        "    c = harness.cell(bench, w['name'])",
        "    harness.driver(c.traffic['driver'])",
        "for m in bench['end_to_end'] + bench['per_layer']:",
        "    harness.reader(m['name'])",
        "import gymgo_tpu_torch.env.batch_env, gymgo_tpu_torch.rl.gumbel_mcts, gymgo_tpu_torch.utils.gtp",
        "import gymgo_tpu_torch.models.az_net, gymgo_tpu_torch.gogame",
    ])
    top = loaded(code)
    assert "gymgo_tpu_torch" in top and "portbench" in top
    assert not top & harness.FOREIGN


def test_the_reference_loads_nothing_of_the_program():
    top = loaded("import portbench.reference.go, portbench.reference.aznet, portbench.reference.judge")
    assert not top & (harness.FOREIGN | {"gymgo_tpu_torch"})


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.foreign_modules() == ["jax.numpy"]
