"""The committed digest of the slice's output, re-derived on the CPU.

tests/goldens/torch_port_bbit_nibble.json holds the SHA-256 of the JAX
package's `--fastcmp 0.5 --bbit-sigs --binary-output` output over a
seeded corpus (n=777, -S 256, -k 31, 4 kb genomes; splitmix64 bases, so
no numpy version changes them). This test ties that digest to the JAX
package and to the port's plain PyTorch path; chip_smoke.py holds the
port's CUDA path to the same digest on the card.
"""

import hashlib
import json
import os

import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.io.corpus import write_corpus

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_port_bbit_nibble.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def workdir(golden, tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    c = golden["corpus"]
    paths = write_corpus(str(d / "fa"), c["seed"], c["n_ancestors"],
                         c["n_mutants"], c["length"], tuple(c["divergence"]))
    assert len(paths) == golden["n"]
    (d / "list.txt").write_text("\n".join(paths) + "\n")
    return d


def _digest(main, argv, workdir, extra=()):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert main(list(argv) + list(extra)) == 0
        with open("out.bin", "rb") as f:
            data = f.read()
        os.remove("out.bin")
    finally:
        os.chdir(cwd)
    return len(data), hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("package", ["jax", "port-cpu"])
def test_golden_digest(golden, workdir, package):
    if package == "jax":
        got = _digest(jax_cli.main, golden["argv"], workdir)
    else:
        got = _digest(cli.main, golden["argv"], workdir, ["--device", "cpu"])
    assert got == (golden["bytes"], golden["sha256"])
