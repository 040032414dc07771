"""The port's LSTM (``ops/recurrent.py``, ``core/input_joiner.py``,
``units/lstm.py``, ``units/lstm_scan.py``, ``samples/sequence.py``)
against the JAX package's, on the CPU, in float64:

* ``lstm_cell`` and ``lstm_scan`` forward equal ``lstm_cell_jax`` /
  ``lstm_scan_jax`` within 1e-12, and their backward (autograd through
  the loop) equals ``jax.vjp`` of the scan within 1e-10: every gate's
  weights and bias, and the inputs;
* ``GDLSTMScan`` after 3 steps (momentum 0.9, weight decay) from JAX's
  gate parameters: the parameters, the velocities and ``err_input``
  within 1e-10 of JAX's after each step;
* the unit-graph ``LSTM`` / ``GDLSTM`` (the twin of ``tests/unit/
  test_kohonen_rbm_lstm.py``'s ``test_lstm_cell_forward_backward``):
  output, memory, the three errors and the updated gates within 1e-12,
  and the scan over one step equals the cell;
* ``LSTM`` and ``lstm_scan`` resolve in the layer registry;
* ``sequence`` for 3 epochs: each segment's n_err equal to JAX's, the
  gate parameters within 1e-10;
* ``params.lstm_params_from_numpy`` / ``lstm_params_to_numpy`` on both
  units.
"""

import jax
import numpy
import torch

from test_torch_mnist import _one_torch_thread, f64  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.ops import recurrent as jax_recurrent
from znicz_tpu.samples import sequence as jax_sequence
from znicz_tpu.units import lstm as jax_lstm
from znicz_tpu.units import lstm_scan as jax_lstm_scan
from znicz_tpu_torch import params
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.ops import recurrent
from znicz_tpu_torch.samples import sequence
from znicz_tpu_torch.units import lstm, lstm_scan
from znicz_tpu_torch.units.nn_units import mapping

CPU = torch.device("cpu")
GATES = recurrent.GATES


def _array(a):
    arr = Array(numpy.array(a))
    arr.device = CPU
    return arr


def _gates(seed, n_in, hidden, scale=0.4):
    r = numpy.random.RandomState(seed)
    return {name: {"w": r.uniform(-scale, scale, (hidden, n_in + hidden)),
                   "b": r.uniform(-scale, scale, hidden)}
            for name in GATES}


def _torch_tree(tree, grad=False):
    return {name: {k: torch.tensor(v, requires_grad=grad)
                   for k, v in p.items()} for name, p in tree.items()}


def _max_diff(got, want):
    return max(numpy.abs(numpy.asarray(got[n][k]) -
                         numpy.asarray(want[n][k])).max()
               for n in want for k in want[n])


def test_recurrent_gate_order_is_jax():
    assert recurrent.GATES == jax_recurrent.GATES


def test_cell_and_scan_forward_equal_jax():
    t_len, batch, n_in, hidden = 5, 3, 4, 6
    r = numpy.random.RandomState(1)
    p = _gates(2, n_in, hidden)
    xs = r.uniform(-1, 1, (t_len, batch, n_in))
    h0 = r.uniform(-1, 1, (batch, hidden))
    c0 = r.uniform(-1, 1, (batch, hidden))
    y, c = recurrent.lstm_cell(_torch_tree(p), torch.tensor(xs[0]),
                               torch.tensor(h0), torch.tensor(c0))
    jy, jc = jax_recurrent.lstm_cell_jax(p, xs[0], h0, c0)
    assert numpy.abs(y.numpy() - numpy.asarray(jy)).max() < 1e-12
    assert numpy.abs(c.numpy() - numpy.asarray(jc)).max() < 1e-12
    ys, h, c = recurrent.lstm_scan(_torch_tree(p), torch.tensor(xs),
                                   torch.tensor(h0), torch.tensor(c0))
    jys, jh, jc = jax_recurrent.lstm_scan_jax(p, xs, h0, c0)
    assert ys.shape == (t_len, batch, hidden)
    for got, want in ((ys, jys), (h, jh), (c, jc)):
        assert numpy.abs(got.numpy() - numpy.asarray(want)).max() < 1e-12


def test_scan_backward_equals_jax_vjp():
    """From ``h0 = c0 = 0`` with only the last step's error, as
    ``GDLSTMScan`` takes it."""
    t_len, batch, n_in, hidden = 7, 4, 5, 3
    r = numpy.random.RandomState(3)
    p = _gates(4, n_in, hidden)
    xs = r.uniform(-1, 1, (t_len, batch, n_in))
    err_h = r.uniform(-1, 1, (batch, hidden))

    def f(pp, x):
        h0 = jax.numpy.zeros((batch, hidden), dtype=x.dtype)
        return jax_recurrent.lstm_scan_jax(pp, x, h0, h0)[1]
    _, vjp = jax.vjp(f, p, xs)
    want_p, want_x = vjp(err_h)
    tp = _torch_tree(p, grad=True)
    tx = torch.tensor(xs, requires_grad=True)
    zero = torch.zeros((batch, hidden), dtype=torch.float64)
    _, h, _ = recurrent.lstm_scan(tp, tx, zero, zero)
    leaves = [tp[n][k] for n in GATES for k in ("w", "b")]
    grads = torch.autograd.grad(h, leaves + [tx],
                                grad_outputs=torch.tensor(err_h))
    got_p = {n: {k: grads[2 * i + j].numpy()
                 for j, k in enumerate(("w", "b"))}
             for i, n in enumerate(GATES)}
    assert _max_diff(got_p, want_p) < 1e-10
    assert numpy.abs(grads[-1].numpy() - numpy.asarray(want_x)).max() \
        < 1e-10


def _scan_pair(pkg, batch, t_len, feats, hidden, **gd_kwargs):
    if pkg == "jax":
        wf, units, arr = DummyWorkflow(), jax_lstm_scan, JaxArray
        kw = {"device": JaxDevice()}
    else:
        wf, units, arr = Workflow(None), lstm_scan, _array
        kw = {"device": "cpu"}
    fwd = units.LSTMScan(wf, output_sample_shape=(hidden,),
                         weights_stddev=0.2, bias_stddev=0.2)
    fwd.input = arr(numpy.zeros((batch, t_len, feats)))
    fwd.initialize(**kw)
    gd = units.GDLSTMScan(wf, **gd_kwargs)
    gd.bind_forward(fwd)
    gd.input = fwd.input
    gd.err_output = arr(numpy.zeros((batch, hidden)))
    gd.initialize(**kw)
    return fwd, gd


def test_gdlstmscan_three_steps_equal_jax():
    batch, t_len, feats, hidden = 4, 6, 5, 3
    hyper = dict(learning_rate=0.1, learning_rate_bias=0.05,
                 weights_decay=0.01, gradient_moment=0.9)
    jfwd, jgd = _scan_pair("jax", batch, t_len, feats, hidden, **hyper)
    fwd, gd = _scan_pair("torch", batch, t_len, feats, hidden, **hyper)
    params.lstm_params_from_numpy(fwd, jfwd.gate_state)
    assert _max_diff(params.lstm_params_to_numpy(fwd), jfwd.gate_state) \
        == 0
    r = numpy.random.RandomState(5)
    for step in range(3):
        xs = r.uniform(-1, 1, (batch, t_len, feats))
        err = r.uniform(-1, 1, (batch, hidden))
        for f, g in ((jfwd, jgd), (fwd, gd)):
            f.input.map_invalidate()
            f.input.mem[...] = xs
            g.err_output.map_invalidate()
            g.err_output.mem[...] = err
            f.run()
            g.run()
        assert numpy.abs(fwd.output.mem - numpy.asarray(jfwd.output.mem)
                         ).max() < 1e-12
        assert _max_diff(fwd.gate_state, jfwd.gate_state) < 1e-10, step
        assert gd.err_input.shape == (batch, t_len, feats)
        assert numpy.abs(gd.err_input.mem - numpy.asarray(
            jgd.err_input.mem)).max() < 1e-10
    got_opt, want_opt = gd.scan_opt_state, jgd.scan_opt_state
    for name in GATES:
        for key in ("w", "b"):
            assert numpy.abs(got_opt[name][key]["vel"] - numpy.asarray(
                want_opt[name][key]["vel"])).max() < 1e-10


def test_scan_pair_draws_jax_gates():
    for pkg in (jax_prng, prng):
        pkg.get(1).seed(99)
    jfwd, _ = _scan_pair("jax", 2, 3, 4, 5)
    fwd, gd = _scan_pair("torch", 2, 3, 4, 5)
    assert _max_diff(fwd.gate_state, jfwd.gate_state) == 0
    assert (fwd.gate_state["forget_gate"]["b"] > 0.7).all()
    gd.gate_skip <<= True
    before = fwd.gate_state
    gd.run()
    assert _max_diff(fwd.gate_state, before) == 0


def _cell(pkg, x, hidden, weights):
    if pkg == "jax":
        wf, mod, arr, kw = DummyWorkflow(), jax_lstm, JaxArray, {
            "device": JaxDevice()}
    else:
        wf, mod, arr, kw = Workflow(None), lstm, _array, {"device": "cpu"}
    batch = x.shape[0]
    cell = mod.LSTM(wf, output_sample_shape=(hidden,), weights_stddev=0.1,
                    bias_stddev=0.1)
    cell.input = arr(x.copy())
    cell.prev_output = arr(numpy.zeros((batch, hidden)))
    cell.prev_memory = arr(numpy.zeros((batch, hidden)))
    cell.initialize(**kw)
    if weights is not None:
        params.lstm_params_from_numpy(cell, weights)
    return wf, mod, arr, kw, cell


def test_unit_graph_cell_forward_backward_equal_jax():
    r = numpy.random.RandomState(5)
    batch, in_size, hidden = 4, 6, 5
    x = r.uniform(-1, 1, (batch, in_size))
    err = r.uniform(-0.1, 0.1, (batch, hidden))
    out, weights = {}, None
    for pkg in ("jax", "torch"):
        wf, mod, arr, kw, cell = _cell(pkg, x, hidden, weights)
        if weights is None:
            weights = jax_recurrent.params_from_cell(cell)
        cell.run()
        res = {"output": numpy.array(cell.output.mem),
               "memory": numpy.array(cell.memory.mem)}
        gd_cell = mod.GDLSTM(wf, cell, learning_rate=0.1)
        gd_cell.err_output = arr(err.copy())
        gd_cell.err_memory = arr(numpy.zeros((batch, hidden)))
        gd_cell.initialize(**kw)
        gd_cell.run()
        for name in ("err_input", "err_prev_output", "err_prev_memory"):
            res[name] = numpy.array(getattr(gd_cell, name).mem)
        res["gates"] = jax_recurrent.params_from_cell(cell) \
            if pkg == "jax" else params.lstm_params_to_numpy(cell)
        cell.run()
        res["output2"] = numpy.array(cell.output.mem)
        out[pkg] = res
    got, want = out["torch"], out["jax"]
    assert got["err_input"].shape == (batch, in_size)
    assert got["err_prev_output"].shape == (batch, hidden)
    assert got["err_prev_memory"].shape == (batch, hidden)
    for name in ("output", "memory", "err_input", "err_prev_output",
                 "err_prev_memory", "output2"):
        assert numpy.abs(got[name] - want[name]).max() < 1e-12, name
    assert _max_diff(got["gates"], want["gates"]) < 1e-12
    assert _max_diff(got["gates"], weights) > 0
    assert numpy.abs(got["output2"] - got["output"]).max() > 0
    # one step of the scan is the cell
    zero = torch.zeros((batch, hidden), dtype=torch.float64)
    _, h, c = recurrent.lstm_scan(_torch_tree(weights),
                                  torch.tensor(x[None]), zero, zero)
    assert numpy.abs(h.numpy() - got["output"]).max() < 1e-12
    assert numpy.abs(c.numpy() - got["memory"]).max() < 1e-12


def test_lstm_params_round_trip():
    x = numpy.random.RandomState(6).uniform(-1, 1, (3, 4))
    *_, cell = _cell("torch", x, 2, None)
    want = _gates(7, 4, 2)
    params.lstm_params_from_numpy(cell, want)
    assert _max_diff(params.lstm_params_to_numpy(cell), want) == 0
    assert _max_diff(recurrent.params_from_cell(cell), want) == 0
    other = lstm.LSTM(cell.workflow, output_sample_shape=(2,))
    other.link_weights(cell)
    assert other.input_gate.weights is cell.input_gate.weights


def test_lstm_types_resolve_in_the_registry():
    assert mapping["LSTM"].forward is lstm.LSTM
    assert next(mapping["LSTM"].backwards) is lstm.GDLSTM
    assert mapping["lstm_scan"].forward is lstm_scan.LSTMScan
    assert next(mapping["lstm_scan"].backwards) is lstm_scan.GDLSTMScan


def _sequence_run(module, pkg, device, tmp_path):
    pkg.get(1).seed(1234)
    pkg.get(2).seed(5678)
    wf = module.build(decision_config={"max_epochs": 3},
                      snapshotter_config={"directory": str(tmp_path)})
    hist, d = [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        hist.append((d.minibatch_class, d.epoch_n_err[d.minibatch_class]))
    d.on_last_minibatch = on_last_minibatch
    wf.initialize(**device)
    wf.run()
    return wf, hist


def test_sequence_3_epochs_equals_jax(f64, tmp_path):
    wf, got = _sequence_run(sequence, prng, {"device": "cpu"}, tmp_path)
    jwf, want = _sequence_run(jax_sequence, jax_prng, {}, tmp_path)
    assert [type(f).__name__ for f in wf.forwards] == ["LSTMScan",
                                                      "All2AllSoftmax"]
    assert type(wf.gds[0]).__name__ == "GDLSTMScan"
    assert wf.loader.minibatch_data.shape == (50, 12, 8)
    assert len(got) == 6 and got == want
    assert got[-1][1] < got[1][1]
    assert _max_diff(wf.forwards[0].gate_state,
                     jwf.forwards[0].gate_state) < 1e-10
    assert wf.forwards[0].gate_state["input_gate"]["w"].dtype == \
        numpy.float64


def test_sequence_dry_run_builds_the_published_graph():
    wf = sequence.build()
    wf.initialize(device="cpu")
    fwd = wf.forwards[0]
    assert fwd.hidden == 32 and fwd.input.shape == (50, 12, 8)
    assert fwd.gate_state["memory_maker"]["w"].shape == (32, 40)
    assert wf.forwards[1].output.shape == (50, 4)
    assert wf.gds[0].forward_unit is fwd and not wf.gds[0].need_err_input
