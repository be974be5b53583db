"""The port's examples (``examples/torch_*.py``) run on the CPU at a small
size, each in a subprocess with a timeout, and print what their
references print; the quickstart's payload loads in the JAX package and
decodes there as it does in the port."""
import os
import subprocess
import sys

import numpy as np
import pytest
from repro_torch import codecs as tcodecs

import repro.codecs as jcodecs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 240

EXAMPLES = {
    "torch_quickstart.py": (["--epochs", "2", "--fleet-entries", "256"],
                            ["TensorCodec: fitness=", "same budget: fitness=",
                             "decode after round-trip", "codec service (nttd): coalesced",
                             "fleet (3 instances): bit-identical", "0 failed tickets"]),
    "torch_serve_llm.py": (["--requests", "4"],
                           ["serving qwen1.5-4b-smoke", "req 0: generated",
                            "4 requests, 48 tokens"]),
    "torch_train_lm.py": (["--steps", "4"], ["loss ", "over 4 steps", "checkpoints in "]),
    "torch_compressed_checkpoint.py": (["--steps", "2", "--epochs", "2"],
                                       ["trained 2 steps, loss", "checkpoint: ",
                                        "eval loss: original"]),
}


def _run(name: str, *args: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name), "--device",
                          "cpu", *args], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("name", [n for n in EXAMPLES if n != "torch_quickstart.py"])
def test_example_runs_on_the_cpu(name):
    args, expected = EXAMPLES[name]
    out = _run(name, *args)
    for text in expected:
        assert text in out, (text, out)


def test_quickstart_payload_loads_in_the_reference(tmp_path):
    args, expected = EXAMPLES["torch_quickstart.py"]
    path = str(tmp_path / "stock.tcdc")
    out = _run("torch_quickstart.py", *args, "--out", path)
    for text in expected:
        assert text in out, (text, out)
    with open(path, "rb") as f:
        blob = f.read()
    ref = jcodecs.load_bytes(blob)
    port = tcodecs.load_bytes(blob, device="cpu")
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s, 512) for s in port.shape], axis=1)
    np.testing.assert_allclose(port.decode_at(idx), ref.decode_at(idx), rtol=1e-5, atol=1e-5)
    assert ref.to_bytes() == port.to_bytes()
