"""The committed digests of the slices' output, re-derived on the CPU.

tests/goldens/torch_port_{bbit,ab}_nibble.json, torch_port_full.json,
torch_port_u8_bbit.json and torch_port_u16_ab.json hold the SHA-256 of
the JAX package's `--fastcmp 0.5 [--bbit-sigs] --binary-output`, default
full-register (no --fastcmp), `--fastcmp 1 --bbit-sigs` and
`--fastcmp 2` output over a seeded corpus (n=777, -S 256, -k 31, 4 kb
genomes; splitmix64 bases, so no numpy version changes them);
torch_port_panel.json that of a `-Q` panel (`--fastcmp 1 --containment`,
every tenth item a query), torch_port_knn.json of `--topk 10` and
torch_port_dedup.json of `--greedy 0.8 --fastcmp 0.5 --bbit-sigs` over
the same corpus. These tests
tie each digest to the JAX package (under the golden's "env", if any) and
to the port's plain PyTorch path; chip_smoke.py holds the port's CUDA
path to the same digests on the card. The port also reproduces the JAX
package's own goldens of these modes (n=6, which the JAX package computes
on its numpy route): the a/b tests/goldens/fastcmp_nibble.bin, the u8
b-bit fastcmp_bbit.bin, the full-register oph_sim.bin and
oph_phylip.txt, the `--mash-dist` mash_dist.txt, the `-o` stacked
signatures sigs.bin with sigs.bin.names.txt, the FullSetSketch
full_sim.bin (`--full`), the exact k-mer set exact_set.bin (`--set`),
and the weighted sketches multiset.bin (`--multiset`) and prob.bin
(`--prob`). A golden configuration with a flag the port does not run is
rejected by that flag's name.
"""

import hashlib
import json
import os
import sys

import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.io.corpus import write_corpus

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = {"bbit": "torch_port_bbit_nibble.json",
           "ab": "torch_port_ab_nibble.json",
           "full": "torch_port_full.json",
           "u8-bbit": "torch_port_u8_bbit.json",
           "u16-ab": "torch_port_u16_ab.json",
           "panel": "torch_port_panel.json",
           "knn": "torch_port_knn.json",
           "dedup": "torch_port_dedup.json"}


@pytest.fixture(scope="module", params=sorted(GOLDENS))
def golden(request):
    with open(os.path.join(HERE, "goldens", GOLDENS[request.param])) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def workdir(golden, tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    c = golden["corpus"]
    paths = write_corpus(str(d / "fa"), c["seed"], c["n_ancestors"],
                         c["n_mutants"], c["length"], tuple(c["divergence"]))
    assert len(paths) == golden["n"]
    (d / "list.txt").write_text("\n".join(paths) + "\n")
    every = golden.get("queries_every")
    if every:
        (d / "refs.txt").write_text("\n".join(
            p for i, p in enumerate(paths) if i % every) + "\n")
        (d / "queries.txt").write_text("\n".join(paths[::every]) + "\n")
    return d


def _digest(main, argv, workdir, extra=(), out="out.bin"):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert main(list(argv) + list(extra)) == 0
        with open(out, "rb") as f:
            data = f.read()
        os.remove(out)
    finally:
        os.chdir(cwd)
    return len(data), hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("package", ["jax", "port-cpu"])
def test_golden_digest(golden, workdir, package, monkeypatch):
    if package == "jax":
        for key, val in golden.get("env", {}).items():
            monkeypatch.setenv(key, val)
        got = _digest(jax_cli.main, golden["argv"], workdir)
    else:
        got = _digest(cli.main, golden["argv"], workdir, ["--device", "cpu"])
    assert got == (golden["bytes"], golden["sha256"])


def _reproduce_jax_golden(name, tmp_path, extra=()):
    """The port's CLI with the JAX package's golden config `name` (and
    the flags `extra`), in the golden fixtures' directory, against the
    committed file."""
    sys.path.insert(0, HERE)
    try:
        from golden_configs import CONFIGS, LENGTH, N_GENOMES
        from make_fixtures import make
    finally:
        sys.path.remove(HERE)
    make(str(tmp_path), n_genomes=N_GENOMES, length=LENGTH, seed=42)
    args, _ = CONFIGS[name]
    got = _digest(cli.main, list(args) + list(extra), tmp_path,
                  ["--device", "cpu"], out=name)
    with open(os.path.join(HERE, "goldens", name), "rb") as f:
        want = f.read()
    assert got == (len(want), hashlib.sha256(want).hexdigest())


def test_port_reproduces_jax_fastcmp_nibble_golden(tmp_path):
    _reproduce_jax_golden("fastcmp_nibble.bin", tmp_path)


def test_port_reproduces_jax_fastcmp_bbit_golden(tmp_path):
    """`--fastcmp 1 --bbit-sigs` at n=6: the JAX package's numpy route,
    whose b-bit epilogue is one IEEE division."""
    _reproduce_jax_golden("fastcmp_bbit.bin", tmp_path)


@pytest.mark.parametrize("name", ["oph_sim.bin", "oph_phylip.txt"])
def test_port_reproduces_jax_full_register_goldens(name, tmp_path):
    _reproduce_jax_golden(name, tmp_path)


def test_port_reproduces_jax_mash_dist_golden(tmp_path):
    """`--mash-dist` (POISSON_LLR) TSV at n=6, the numpy route."""
    _reproduce_jax_golden("mash_dist.txt", tmp_path)


def test_port_reproduces_jax_full_setsketch_golden(tmp_path):
    """`--full` at n=6: FullSetSketch registers, compared as full
    registers on the numpy route."""
    _reproduce_jax_golden("full_sim.bin", tmp_path)


def test_port_reproduces_jax_stacked_signatures_golden(tmp_path):
    """`-o sigs.bin --cmpout /dev/null`: the stacked signatures and their
    names file byte for byte."""
    _reproduce_jax_golden("sigs.bin", tmp_path)
    with open(os.path.join(HERE, "goldens", "sigs.bin.names.txt"),
              "rb") as f:
        want = f.read()
    with open(tmp_path / "sigs.bin.names.txt", "rb") as f:
        assert f.read() == want


def test_port_reproduces_jax_exact_set_golden(tmp_path):
    """`--set` at n=6: exact k-mer sets, their intersections joined in
    torch."""
    _reproduce_jax_golden("exact_set.bin", tmp_path)


@pytest.mark.parametrize("name", ["multiset.bin", "prob.bin"])
def test_port_reproduces_jax_weighted_goldens(name, tmp_path):
    """`--multiset` and `--prob` at n=6: the weighted registers (the port's
    f32 log and exp are XLA's), compared for equality on the numpy
    route."""
    _reproduce_jax_golden(name, tmp_path)


@pytest.mark.parametrize("name, flag", [("multiset.bin", "--hp-compress"),
                                        ("prob.bin", "--entmin")])
def test_goldens_outside_the_port_are_rejected_by_flag(name, flag, tmp_path):
    """--entmin is refused (exit 2). --hp-compress runs since the port's
    minimizer sequences, and changes only --seq jobs: the golden's bytes."""
    if flag == "--hp-compress":
        _reproduce_jax_golden(name, tmp_path, [flag])
        return
    sys.path.insert(0, HERE)
    try:
        from golden_configs import CONFIGS
    finally:
        sys.path.remove(HERE)
    args, _ = CONFIGS[name]
    with pytest.raises(SystemExit) as e:
        cli.main(list(args) + [flag, "--device", "cpu"])
    assert e.value.code == 2
