"""Genetic hyperparameter optimization over a config's ``Range`` values.

Counterpart of ``znicz_tpu/core/genetics.py`` (the reference's
``veles.genetics``): a config scalar wrapped in :class:`Range` is a
site the optimizer tunes, :func:`fix_config` collapses every site to
its default, and :class:`GeneticsOptimizer` is a plain generational GA
(tournament selection, blend crossover, per-gene mutation, elitism)
whose ``evaluate`` callback trains a workflow from the patched config
and returns a fitness to maximize, or whose ``evaluate_population``
callback scores a whole generation at once
(:mod:`znicz_tpu_torch.parallel.population`).  It runs on the host; its
own ``numpy.random.RandomState(0xEE07)`` stream gives the JAX
package's individuals for the same fitnesses.
"""

import numpy

from znicz_tpu_torch.core.config import Config


class Range(object):
    """A tunable config value: a default inside ``[min, max]``."""

    __slots__ = ("default", "min_value", "max_value")

    def __init__(self, default, min_value, max_value):
        if not min_value <= default <= max_value:
            raise ValueError("default %r outside [%r, %r]"
                             % (default, min_value, max_value))
        self.default = default
        self.min_value = min_value
        self.max_value = max_value

    @property
    def is_integer(self):
        return all(isinstance(v, (int, numpy.integer)) for v in
                   (self.default, self.min_value, self.max_value))

    def clip(self, value):
        value = min(max(value, self.min_value), self.max_value)
        return int(round(value)) if self.is_integer else float(value)

    def sample(self, rand):
        return self.clip(rand.uniform(self.min_value, self.max_value))

    def __repr__(self):
        return "Range(%r, %r, %r)" % (self.default, self.min_value,
                                      self.max_value)


def _walk(node):
    """``(container, key, Range)`` for every Range under ``node``."""
    if isinstance(node, (Config, dict)):
        items = list(node.items())
    elif isinstance(node, (list, tuple)):
        items = list(enumerate(node))
    else:
        return
    for key, value in items:
        if isinstance(value, Range):
            yield node, key, value
        else:
            yield from _walk(value)


def _set(container, key, value):
    if isinstance(container, Config):
        setattr(container, key, value)
    elif isinstance(container, (dict, list)):
        container[key] = value
    else:
        raise TypeError("cannot patch %r inside a tuple" % (key,))


def enumerate_ranges(cfg):
    """Every Range site of a config tree, in a deterministic order."""
    return list(_walk(cfg))


def fix_config(cfg):
    """Collapse every Range to its default."""
    for container, key, rng in enumerate_ranges(cfg):
        _set(container, key, rng.default)
    return cfg


def apply_values(cfg, values):
    """Patch the config's Range sites with ``values``; returns the
    sites."""
    sites = enumerate_ranges(cfg)
    if len(sites) != len(values):
        raise ValueError("%d values for %d Range sites"
                         % (len(values), len(sites)))
    for (container, key, _), value in zip(sites, values):
        _set(container, key, value)
    return sites


class GeneticsOptimizer(object):
    """Generational GA over a config's Range sites.

    ``evaluate(config) -> float`` is called with the patched config and
    returns a fitness to maximize; ``evaluate_population([values, ...])
    -> [fitness, ...]``, when given, scores every new individual of a
    generation in one call.  Fitnesses are memoized by value vector
    (the elite is not trained again).  The config is left with the best
    values found (the defaults if none)."""

    def __init__(self, evaluate, config, population_size=8,
                 generations=5, crossover_rate=0.7, mutation_rate=0.15,
                 rand=None, evaluate_population=None):
        self.evaluate = evaluate
        self.evaluate_population = evaluate_population
        self.config = config
        self.sites = enumerate_ranges(config)
        if not self.sites:
            raise ValueError("config has no Range values to optimize")
        self.ranges = [rng for _, _, rng in self.sites]
        self.population_size = max(3, population_size)
        self.generations = generations
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.rand = rand or numpy.random.RandomState(0xEE07)
        self.best_values = None
        self.best_fitness = -numpy.inf
        #: (best, mean) fitness of each generation
        self.history = []
        self._fitness_cache = {}

    # -- the GA's operators ----------------------------------------------------
    def _random_individual(self):
        return [rng.sample(self.rand) for rng in self.ranges]

    def _tournament(self, population, fitness):
        i, j = self.rand.randint(0, len(population), 2)
        return population[i] if fitness[i] >= fitness[j] else population[j]

    def _crossover(self, a, b):
        """Blend crossover: each gene a random point between the
        parents'."""
        child = []
        for rng, ga, gb in zip(self.ranges, a, b):
            t = self.rand.uniform()
            child.append(rng.clip(ga + t * (gb - ga)))
        return child

    def _mutate(self, ind):
        out = []
        for rng, gene in zip(self.ranges, ind):
            if self.rand.uniform() < self.mutation_rate:
                span = rng.max_value - rng.min_value
                gene = rng.clip(gene + self.rand.normal(0, 0.2 * span))
            out.append(gene)
        return out

    def _fitness_of(self, individual):
        key = tuple(individual)
        cached = self._fitness_cache.get(key)
        if cached is not None:
            return cached
        # the sites taken at construction: the first patch replaces the
        # Range objects in the tree
        for (container, k, _), value in zip(self.sites, individual):
            _set(container, k, value)
        fitness = float(self.evaluate(self.config))
        self._fitness_cache[key] = fitness
        return fitness

    def _fitness_many(self, population):
        """The fitness of each individual of a generation: the new ones
        in one ``evaluate_population`` call where there is one, else
        one ``evaluate`` each."""
        if self.evaluate_population is None:
            return [self._fitness_of(ind) for ind in population]
        missing, seen = [], set()
        for ind in population:
            key = tuple(ind)
            if key not in self._fitness_cache and key not in seen:
                seen.add(key)
                missing.append(list(ind))
        if missing:
            values = self.evaluate_population(missing)
            if len(values) != len(missing):
                raise ValueError(
                    "evaluate_population returned %d fitnesses for %d "
                    "individuals" % (len(values), len(missing)))
            for ind, fit in zip(missing, values):
                self._fitness_cache[tuple(ind)] = float(fit)
        return [self._fitness_cache[tuple(ind)] for ind in population]

    # -- the driver ------------------------------------------------------------
    def run(self):
        """Evolve; returns ``(best_values, best_fitness)``."""
        defaults = [rng.default for rng in self.ranges]
        population = [defaults] + [
            self._random_individual()
            for _ in range(self.population_size - 1)]
        try:
            for gen in range(self.generations):
                fitness = self._fitness_many(population)
                order = int(numpy.argmax(fitness))
                if fitness[order] > self.best_fitness:
                    self.best_fitness = fitness[order]
                    self.best_values = list(population[order])
                self.history.append((max(fitness),
                                     float(numpy.mean(fitness))))
                if gen == self.generations - 1:
                    break
                # elitism: the best survives, the rest are offspring
                nxt = [list(population[order])]
                while len(nxt) < self.population_size:
                    a = self._tournament(population, fitness)
                    if self.rand.uniform() < self.crossover_rate:
                        b = self._tournament(population, fitness)
                        child = self._crossover(a, b)
                    else:
                        child = list(a)
                    nxt.append(self._mutate(child))
                population = nxt
        finally:
            winner = self.best_values or defaults
            for (container, key, _), value in zip(self.sites, winner):
                _set(container, key, value)
        return self.best_values, self.best_fitness
