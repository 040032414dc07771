"""``--dump-graph FILE.dot`` in the port's CLI against the JAX package's:
``mnist`` and a narrow ``alexnet`` (``test_torch_fused.narrow_alexnet``
on 67x67x3 rows), through the unit graph and through ``--fused``, each
dumped by both CLIs; the DOT files' node sets (each unit's label: its
name, and its class where they differ) and edge sets (the control
links between those labels) are equal.  Dumping without ``--testing``
is a dry run, as in the JAX CLI: nothing trains.
"""

import re

import pytest

from test_torch_workflow import _restored
from znicz_tpu import __main__ as jax_cli
from znicz_tpu.core.config import root as jax_root
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core.config import root
# the samples install their root.<ns> defaults at import: before any
# test saves those nodes to restore them
import znicz_tpu.samples.mnist  # noqa: F401,E402
import znicz_tpu.samples.research.alexnet  # noqa: F401,E402
import znicz_tpu_torch.samples.alexnet  # noqa: F401,E402
import znicz_tpu_torch.samples.mnist  # noqa: F401,E402

_ALEXNET_PY = """
from test_torch_fused import narrow_alexnet
from %s import alexnet


def run(load, main):
    load(alexnet.build, layers=narrow_alexnet())
    main()
"""
_PACKAGES = {"jax": "znicz_tpu.samples.research",
             "torch": "znicz_tpu_torch.samples"}
_CONFIG = {
    "mnist": {"mnistr.loader.synthetic_train": 60,
              "mnistr.loader.synthetic_valid": 30,
              "mnistr.loader.minibatch_size": 30},
    "alexnet": {"alexnet.loader.n_train": 8, "alexnet.loader.n_valid": 4,
                "alexnet.loader.minibatch_size": 4,
                "alexnet.loader.size": 67},
}


def parse_dot(text):
    """``(node labels, edges between labels)`` of an ``as_dot`` text."""
    labels = dict(re.findall(r'^\s*(u\d+) \[label="(.*)"\];$', text, re.M))
    edges = {(labels[a], labels[b])
             for a, b in re.findall(r"^\s*(u\d+) -> (u\d+);$", text, re.M)}
    return set(labels.values()), edges


def _argv(tmp_path, name, pkg, fused, out):
    if name == "alexnet":
        path = tmp_path / ("alexnet_%s.py" % pkg)
        path.write_text(_ALEXNET_PY % _PACKAGES[pkg])
        argv = [str(path)]
    else:
        argv = [name]
    for key, value in _CONFIG[name].items():
        argv += ["--config", "%s=%s" % (key, value)]
    if fused:
        argv += ["--fused", "pool_impl=offsets" if name == "alexnet"
                 else "window=2"]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    return argv + ["--dump-graph", str(out)]


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused"])
@pytest.mark.parametrize("name", ["mnist", "alexnet"])
def test_dump_graph_equals_jaxs(tmp_path, name, fused, capsys):
    ns = "mnistr" if name == "mnist" else "alexnet"
    nodes = [getattr(r, ns) for r in (root, jax_root)]
    nodes += [n.loader for n in nodes]
    outs = {}
    with _restored(*nodes):
        for pkg, main in (("jax", jax_cli.main), ("torch", cli.main)):
            out = tmp_path / ("%s.dot" % pkg)
            assert main(_argv(tmp_path, name, pkg, fused, out)) == 0
            outs[pkg] = parse_dot(out.read_text())
    capsys.readouterr()
    got_nodes, got_edges = outs["torch"]
    want_nodes, want_edges = outs["jax"]
    assert got_nodes == want_nodes
    assert got_edges == want_edges
    assert len(got_edges) >= len(got_nodes) - 2


def test_dump_graph_is_a_dry_run_unless_testing(tmp_path, monkeypatch):
    """Without ``--testing`` the workflow is built and initialized and
    never run; with it, it runs (the decision stops after an epoch)."""
    from znicz_tpu_torch.core.workflow import Workflow
    runs = []
    real = Workflow.run
    monkeypatch.setattr(Workflow, "run",
                        lambda wf: runs.append(1) or real(wf))
    with _restored(root.mnistr, root.mnistr.loader, root.mnistr.decision):
        argv = _argv(tmp_path, "mnist", "torch", False,
                     tmp_path / "a.dot")
        assert cli.main(argv) == 0
        assert runs == []
        assert cli.main(argv + ["--testing"]) == 0
        assert runs == [1]
    assert parse_dot((tmp_path / "a.dot").read_text())[0]
