"""Kohonen self-organizing map units.

Counterpart of ``znicz_tpu/units/kohonen.py``: ``KohonenForward`` (:21,
the winner of each sample, with the optional ``total`` table of every
sample's winner), ``KohonenTrainer`` (:80, one winner + gravity +
update step a minibatch, under the decaying radius and gradient
schedules), ``KohonenDecision`` (:173, stops on the change of the
weights between epochs) and ``KohonenValidator`` (:214, the greedy
neuron-to-label fitness).  The math is :mod:`znicz_tpu_torch.ops.
kohonen`.

The per-minibatch path reads nothing back.  Where JAX pulls each
step's winner histogram to the host (:162-170) and each minibatch's
winners to fill ``output`` and ``total`` (:72-77), the port adds the
histogram into ``winners`` on the device, keeps ``output`` and
``total`` there, and the validator marks each neuron's samples in a
device mask (``neurons x samples``).  The decision reads the weights
and the winners once an epoch, as JAX's ``on_training_finished`` does,
and the validator's fitness reads its mask once.
"""

import numpy
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import kohonen as koh_ops
from znicz_tpu_torch.units.decision import TrivialDecision


class KohonenForward(AcceleratedUnit):
    """The winner neuron of each sample; with ``total=True`` also every
    sample's winner over the epoch, at the loader's running offset."""

    def __init__(self, workflow, **kwargs):
        super(KohonenForward, self).__init__(workflow, **kwargs)
        self.demand("input", "weights")
        self.argmins = None
        self.output = Array(name="output")
        self.total = Array(name="total") if kwargs.get("total", False) \
            else None
        if self.total is not None:
            self.minibatch_offset = None
            self.minibatch_size = None
            self.batch_size = None

    @property
    def neurons_number(self):
        return self.weights.shape[0]

    @property
    def sample_length(self):
        return self.weights.shape[1]

    def initialize(self, device=None, **kwargs):
        super(KohonenForward, self).initialize(device=device, **kwargs)
        assert self.input.sample_size == self.sample_length
        self.output.reset(numpy.zeros(self.input.shape[0],
                                      dtype=numpy.int32))
        self.output.device = self.device
        if self.total is not None:
            self.total.reset(numpy.zeros(self.batch_size,
                                         dtype=numpy.int32))
            self.total.device = self.device

    def run(self):
        if self.argmins is not None:
            winners = self.argmins.dev
        else:
            winners = koh_ops.winners(self.input.dev, self.weights.dev)
        self.output.set_dev(winners)
        if self.total is not None:
            length = int(self.minibatch_size)
            end = int(self.minibatch_offset)
            total = self.total.dev.clone()
            total[end - length:end] = winners[:length]
            self.total.set_dev(total)


class KohonenTrainer(AcceleratedUnit):
    """One SOM step a minibatch; ``time`` counts the minibatches, and
    ``gravity_radius`` / ``gradient_multiplier`` read the schedules at
    it."""

    def __init__(self, workflow, **kwargs):
        super(KohonenTrainer, self).__init__(workflow, **kwargs)
        self.argmins = Array(name="argmins")
        self.weights = Array(name="weights")
        self.winners = Array(name="winners")
        self._coords = Array(name="coords")
        self.weights_filling = kwargs.get("weights_filling", "uniform")
        self.weights_stddev = kwargs.get("weights_stddev", None)
        self.rand = kwargs.get("rand", prng.get())
        self.time = 0
        self._sigma = 0
        self.gradient_decay = kwargs.get(
            "gradient_decay", lambda t: 0.1 / (1.0 + t * 0.05))
        self.radius_decay = kwargs.get(
            "radius_decay", lambda t: 1.0 / (1.0 + t * 0.05))
        self.input_max_supposed = kwargs.get("input_max_supposed", 1.0)
        self._shape = kwargs.get("shape")
        self.demand("input", "shape")

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, value):
        self._shape = value

    @property
    def gravity_radius(self):
        return self.radius_decay(self.time) * self._sigma

    @property
    def gradient_multiplier(self):
        return self.gradient_decay(self.time)

    def _get_weights_magnitude(self):
        return 9.0 / (self.input_max_supposed * self._sample_length)

    def initialize(self, device=None, **kwargs):
        super(KohonenTrainer, self).initialize(device=device, **kwargs)
        self._neurons_number = self.shape[0] * self.shape[1]
        self._sample_length = self.input.sample_size
        if self.weights_stddev is None:
            self.weights_stddev = min(self._get_weights_magnitude(), 0.05)
        if not self.weights:
            w = numpy.zeros((self._neurons_number, self._sample_length),
                            dtype=self.input.dtype)
            if self.weights_filling == "uniform":
                self.rand.fill(w, -self.weights_stddev, self.weights_stddev)
            elif self.weights_filling == "gaussian":
                self.rand.fill_normal_real(w, 0, self.weights_stddev)
            else:
                raise ValueError("Invalid weights_filling")
            self.weights.reset(w)
        else:
            assert self.weights.shape == (self._neurons_number,
                                          self._sample_length)
        self.winners.reset(numpy.zeros(self._neurons_number, numpy.int32))
        self.argmins.reset(numpy.zeros(self.input.shape[0], numpy.int32))
        coords = koh_ops.make_coords(self._neurons_number)
        self._coords.reset(coords.astype(self.weights.dtype))
        self._sigma = (coords.ravel().max() - coords.ravel().min()) * 1.42
        for arr in (self.weights, self.winners, self.argmins, self._coords):
            arr.device = self.device

    def run(self):
        new_w, hist, argmins = koh_ops.train_step(
            self.input.dev, self.weights.dev, self._coords.dev,
            self.gravity_radius, self.gradient_multiplier)
        self.weights.set_dev(new_w)
        self.winners.set_dev(self.winners.dev + hist)
        self.argmins.set_dev(argmins)
        self.time += 1


class KohonenDecision(TrivialDecision):
    """Stops when the weights moved less than ``weights_min_diff`` over
    an epoch (or at ``max_epochs``); takes the weights and the epoch's
    winners at each TRAIN segment's end and zeroes the winners."""

    def __init__(self, workflow, **kwargs):
        super(KohonenDecision, self).__init__(workflow, **kwargs)
        self.weights_mem = numpy.empty((0, 0), dtype=numpy.float32)
        self._prev_weights = numpy.empty((0, 0), dtype=numpy.float32)
        self.winners_mem = numpy.empty((0, 0))
        self.weights_min_diff = kwargs.get("weights_min_diff", 0)
        self.demand("weights", "winners")

    @property
    def weights_diff(self):
        if self.weights_mem.size * self._prev_weights.size == 0:
            return numpy.inf
        return float(numpy.linalg.norm(self.weights_mem -
                                       self._prev_weights))

    def on_training_finished(self):
        self._prev_weights = self.weights_mem.copy()
        self.weights_mem = numpy.array(self.weights.mem)
        self.winners_mem = numpy.array(self.winners.mem)
        self.winners.set_dev(torch.zeros_like(self.winners.dev))

    def train_improve_condition(self):
        if self.weights_diff < self.weights_min_diff:
            return True
        return super(KohonenDecision, self).train_improve_condition()

    def fill_statistics(self, stats):
        stats.append("weights diff: %f" % self.weights_diff)


class KohonenValidator(AcceleratedUnit):
    """The greedy max-intersection assignment of neurons to labels:
    ``fitness`` is the share of samples that fell on a neuron assigned
    to their label, summed over the neurons (a sample counts once for
    each neuron it ever won)."""

    def __init__(self, workflow, **kwargs):
        super(KohonenValidator, self).__init__(workflow, **kwargs)
        self.demand("input", "minibatch_indices", "minibatch_size",
                    "shape", "samples_by_label")
        #: ``(neurons, samples)`` bool on the device: sample s won
        #: neuron n
        self._won = None
        self._fitness = 0
        self._result = {}
        self._fitness_by_label = {}
        self._fitness_by_neuron = []
        self._need_validate = True

    @property
    def neurons_count(self):
        return self.shape[0] * self.shape[1]

    def initialize(self, device=None, **kwargs):
        super(KohonenValidator, self).initialize(device=device, **kwargs)
        self._overall = sum(len(m) for m in self.samples_by_label.values())
        assert self._overall > 0
        n_samples = 1 + max(max(m) for m in self.samples_by_label.values()
                            if len(m))
        self._won = torch.zeros((self.neurons_count, n_samples),
                                dtype=torch.bool, device=self.device)

    @property
    def accumulated_input(self):
        """Each neuron's set of the samples that won it."""
        won = self._won.cpu().numpy()
        return [set(numpy.flatnonzero(row).tolist()) for row in won]

    def reset(self):
        self._won.zero_()
        self._need_validate = True

    def run(self):
        n = int(self.minibatch_size)
        winners = self.input.dev[:n].long()
        indices = self.minibatch_indices.dev[:n].long()
        self._won[winners, indices] = True
        self._need_validate = True

    @property
    def result(self):
        self._validate()
        return self._result

    @property
    def fitness(self):
        self._validate()
        return self._fitness

    @property
    def fitness_by_label(self):
        self._validate()
        return self._fitness_by_label

    @property
    def fitness_by_neuron(self):
        self._validate()
        return self._fitness_by_neuron

    def _validate(self):
        if not self._need_validate:
            return
        accumulated = self.accumulated_input
        intersections = []
        labels = sorted(self.samples_by_label)
        for neuron in range(self.neurons_count):
            for li, label in enumerate(labels):
                members = self.samples_by_label[label]
                intersections.append((
                    len(accumulated[neuron] & set(members)), neuron, li))
        intersections.sort(reverse=True)
        self._result = {label: set() for label in labels}
        fitted = 0
        fitted_by_label = {label: 0 for label in labels}
        fitted_by_neuron = [0] * self.neurons_count
        banned = set()
        for fit, neuron, li in intersections:
            if fit <= 0 or len(banned) >= self.neurons_count:
                break
            if neuron in banned:
                continue
            label = labels[li]
            fitted += fit
            fitted_by_label[label] += fit
            fitted_by_neuron[neuron] = fit
            self._result[label].add(neuron)
            banned.add(neuron)
        self._fitness = fitted / self._overall
        self._fitness_by_label = {
            label: fitted_by_label[label] / len(members)
            for label, members in self.samples_by_label.items()}
        self._fitness_by_neuron = [
            fitted_by_neuron[n] / len(wins) if len(wins) else 0
            for n, wins in enumerate(accumulated)]
        self._need_validate = False
