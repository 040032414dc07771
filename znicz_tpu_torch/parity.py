"""Real-data accuracy parity runs (``python -m znicz_tpu_torch mnist
--parity``).

Counterpart of ``znicz_tpu/parity.py``: :func:`ensure_dataset`
provisions the real dataset from the manifest's mirrors (``DATASETS``,
the role of the reference's per-sample ``manifest.json`` and its
Downloader), :func:`run_parity` trains each published config of a
sample (``PARITY_RUNS``) to its stopping criterion and prints its row
against the reference's validation error.  Where the files are absent
and no mirror answers, provisioning fails fast with a "network
required" message (a short socket timeout) instead of training on the
synthetic fallback.

Parity trains on the fused graph unless ``fused=None``, after a short
cross-check of the first minibatches against the unit graph.  The
default ("auto") parity config is the JAX package's: the fused graph
with bfloat16 products over float32 master weights, and a row that
misses its bar in bfloat16 is trained again in float32 on the same
path (``znicz_tpu/parity.py:248-297``).
"""

import gzip
import importlib
import os
import shutil
import tarfile
import urllib.error
import urllib.request

from znicz_tpu_torch.core.config import root

#: the provisioning manifests: the files a loader needs and the
#: archives or gz files (mirrors in order of preference) that hold them
DATASETS = {
    "mnist": {
        "subdir": "MNIST",
        "files": ("train-images.idx3-ubyte", "train-labels.idx1-ubyte",
                  "t10k-images.idx3-ubyte", "t10k-labels.idx1-ubyte"),
        "sources": [
            # (url pattern, gz member -> target file)
            ("https://ossci-datasets.s3.amazonaws.com/mnist/%s.gz", {
                "train-images-idx3-ubyte": "train-images.idx3-ubyte",
                "train-labels-idx1-ubyte": "train-labels.idx1-ubyte",
                "t10k-images-idx3-ubyte": "t10k-images.idx3-ubyte",
                "t10k-labels-idx1-ubyte": "t10k-labels.idx1-ubyte"}),
            ("https://storage.googleapis.com/cvdf-datasets/mnist/%s.gz", {
                "train-images-idx3-ubyte": "train-images.idx3-ubyte",
                "train-labels-idx1-ubyte": "train-labels.idx1-ubyte",
                "t10k-images-idx3-ubyte": "t10k-images.idx3-ubyte",
                "t10k-labels-idx1-ubyte": "t10k-labels.idx1-ubyte"}),
        ],
    },
    "cifar": {
        "subdir": "CIFAR10",
        "files": tuple(["data_batch_%d" % i for i in range(1, 6)] +
                       ["test_batch"]),
        "tar": ("https://www.cs.toronto.edu/~kriz/"
                "cifar-10-python.tar.gz", "cifar-10-batches-py"),
    },
}

#: the parity rows: sample -> [(label, reference val err %, options)]
PARITY_RUNS = {
    "mnist": [
        ("MNIST MLP", 1.92, {}),
        ("MNIST conv", 0.75, {"layers_key": "mnistr_conv"}),
        ("MNIST caffe", 0.80, {"layers_key": "mnistr_caffe"}),
    ],
    "cifar": [
        ("CIFAR-10 caffe conv", 17.21, {}),
    ],
}

TIMEOUT = 30  # seconds a request: fail fast offline

#: the accuracy slack against the reference before a row reads CHECK
TOLERANCE_PT = 0.15


class NetworkRequired(SystemExit):
    pass


def _fetch(url, dest):
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r, \
            open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)


def _from_tar(spec, directory):
    """Fetch and unpack the spec's archive; raises OSError or URLError."""
    url, member_dir = spec["tar"]
    dest = os.path.join(directory, os.path.basename(url))
    if not os.path.exists(dest):
        _fetch(url, dest)
    try:
        with tarfile.open(dest) as tf:
            # members stay inside the target directory
            tf.extractall(directory, filter="data")
    except tarfile.TarError as e:
        # a truncated archive would fail every retry: drop it
        os.remove(dest)
        raise OSError("corrupt archive removed, re-run: %s" % e)
    src = os.path.join(directory, member_dir)
    if os.path.isdir(src):
        for f in spec["files"]:
            p = os.path.join(src, f)
            if os.path.exists(p):
                shutil.move(p, os.path.join(directory, f))
    still = [f for f in spec["files"]
             if not os.path.exists(os.path.join(directory, f))]
    if still:
        raise OSError("archive did not contain %s" % ", ".join(still))


def _from_gz(pattern, members, directory):
    """Fetch and unpack one gz file a member; raises OSError or
    URLError."""
    for member, target in members.items():
        tpath = os.path.join(directory, target)
        if os.path.exists(tpath):
            continue
        gz = os.path.join(directory, member + ".gz")
        if not os.path.exists(gz):
            _fetch(pattern % member, gz)
        with gzip.open(gz, "rb") as fin, \
                open(tpath + ".part", "wb") as fout:
            shutil.copyfileobj(fin, fout)
        os.replace(tpath + ".part", tpath)


def ensure_dataset(name, directory=None):
    """The directory holding the real dataset ``name``, fetched there
    if its files are absent.  Raises :class:`NetworkRequired` (a
    SystemExit) naming the directory when no mirror answers."""
    spec = DATASETS[name]
    directory = directory or os.path.join(root.common.dirs.datasets,
                                          spec["subdir"])
    missing = [f for f in spec["files"]
               if not os.path.exists(os.path.join(directory, f))]
    if not missing:
        return directory
    os.makedirs(directory, exist_ok=True)
    errors = []
    if "tar" in spec:
        try:
            _from_tar(spec, directory)
            return directory
        except (urllib.error.URLError, OSError) as e:
            errors.append("%s: %s" % (spec["tar"][0], e))
    for pattern, members in spec.get("sources", ()):
        try:
            _from_gz(pattern, members, directory)
            return directory
        except (urllib.error.URLError, OSError) as e:
            errors.append("%s: %s" % (pattern, e))
    raise NetworkRequired(
        "network required: the %s parity run needs the real dataset "
        "(missing %s under %s) and no mirror was reachable:\n  %s\n"
        "Download the files manually into that directory and re-run."
        % (name, ", ".join(missing), directory,
           "\n  ".join(errors) or "no sources configured"))


def _train_n_minibatches(wf, n):
    """Run the workflow until its loader has served ``n`` minibatches
    (``NoMoreJobs`` unwinds the engine); the n-th serve forces
    ``last_minibatch`` so an open fused window flushes its stats
    through the evaluator and the decision first."""
    from znicz_tpu_torch.core.workflow import NoMoreJobs
    loader = wf.loader
    count = [0]
    real_run = loader.run

    def limited_run():
        if count[0] >= n:
            raise NoMoreJobs()
        count[0] += 1
        real_run()
        if count[0] >= n:
            loader.last_minibatch <<= True

    loader.run = limited_run
    try:
        wf.run()
    finally:
        loader.run = real_run


def _seeded_build(module, build_kwargs, loader_config, fused_cfg, device):
    from znicz_tpu_torch.core import prng
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    kwargs = dict(build_kwargs)
    if fused_cfg is not None:
        kwargs["fused"] = dict(fused_cfg)
    wf = module.build(loader_config=dict(loader_config), **kwargs)
    wf.initialize(device=device)
    return wf


def _cross_check(module, build_kwargs, loader_config, fused_cfg,
                 device, n_minibatches=16):
    """Train the first ``n_minibatches`` in both graphs from the same
    seeds and compare their training error rates: a wiring check of
    the fused parity run against the unit graph (within 0.05)."""
    from znicz_tpu_torch.loader.base import TRAIN

    def train(fused):
        wf = _seeded_build(module, build_kwargs, loader_config, fused,
                           device)
        _train_n_minibatches(wf, n_minibatches)
        errs = wf.decision.epoch_n_err[TRAIN] or 0
        total = wf.decision.epoch_n_evaluated_samples[TRAIN]
        return errs / max(total, 1), total

    rate_f, seen_f = train(fused_cfg)
    rate_u, seen_u = train(None)
    if seen_f == 0 or seen_u == 0:
        raise SystemExit("parity cross-check saw no training samples")
    if abs(rate_f - rate_u) > 0.05:
        raise SystemExit(
            "parity cross-check FAILED: first-%d-minibatch train error "
            "%.3f (fused) vs %.3f (unit graph): the fused graph is "
            "mis-wired; rerun with --fused window=1 or file the "
            "divergence" % (n_minibatches, rate_f, rate_u))
    print("cross-check ok: first %d minibatches, train err %.3f (fused) "
          "vs %.3f (unit graph)" % (n_minibatches, rate_f, rate_u))


def run_parity(sample, device=None, data_dir=None, fused="auto",
               cross_check=16):
    """Provision the data, train every parity config of ``sample`` to
    its stopping criterion on ``device`` (the card unless "cpu") and
    print the table; returns the rows ``(label, reference err %, our
    err %)``.  ``fused`` "auto" or True is the fused graph's default
    parity config, ``{"compute_dtype": "bfloat16"}`` with a float32
    retry of a row that misses its bar; a dict overrides it (e.g.
    ``{"window": 1}``), None trains the unit graph."""
    if sample not in PARITY_RUNS:
        raise SystemExit(
            "no parity baseline registered for %r (have: %s)"
            % (sample, ", ".join(sorted(PARITY_RUNS))))
    from znicz_tpu_torch.core.backends import default_device
    device = default_device(device)
    data_dir = ensure_dataset(sample, directory=data_dir)
    module = importlib.import_module("znicz_tpu_torch.samples." + sample)
    if fused == "auto" or fused is True:
        fused = {"compute_dtype": "bfloat16"}
    loader_config = {"synthetic": False, "data_path": data_dir}
    rows = []
    for label, ref_err, opts in PARITY_RUNS[sample]:
        kwargs = {}
        layers_key = opts.get("layers_key")
        if layers_key is not None:
            kwargs["layers"] = getattr(root, layers_key).layers
        if fused is not None and cross_check:
            _cross_check(module, kwargs, loader_config, fused, device,
                         n_minibatches=cross_check)

        def train_full(fused_cfg):
            wf = _seeded_build(module, kwargs, loader_config, fused_cfg,
                               device)
            wf.run()
            return wf.decision.best_n_err_pt[1]

        ours = train_full(fused)
        bf16 = fused is not None and fused.get("compute_dtype") is not None
        mode = "unit graph" if fused is None else \
            "fused bf16" if bf16 else "fused f32"
        if bf16 and (ours is None or ours > ref_err + TOLERANCE_PT):
            # bf16 missed the bar: the row again in f32 on the same path
            print("| %-22s | bf16 %s missed %.2f%% bar; retrying f32 |"
                  % (label, "%.2f%%" % ours if ours is not None else "n/a",
                     ref_err))
            ours_f32 = train_full(dict(fused, compute_dtype=None))
            if ours is None or (ours_f32 is not None and ours_f32 < ours):
                ours, mode = ours_f32, "fused f32"
        rows.append((label, ref_err, ours))
        print("| %-22s | reference %6.2f%% | ours %8s (%s) | %s |"
              % (label, ref_err,
                 "%.2f%%" % ours if ours is not None else "n/a", mode,
                 "PASS" if ours is not None and
                 ours <= ref_err + TOLERANCE_PT else "CHECK"))
    return rows
