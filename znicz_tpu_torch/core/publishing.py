"""Publisher — the end-of-training report.

Counterpart of ``znicz_tpu/core/publishing.py``: once the decision
completes, the publisher gathers the result providers' metrics
(``get_metric_names`` / ``get_metric_values`` of the decision and the
evaluator), the loader's sizes, the units' timings, the rendered plots
and, while telemetry is on, the metrics snapshot, and writes them
through its backends — ``markdown``, ``json`` and ``html`` files in a
directory (default ``<root.common.dirs.cache>/reports``).
"""

import glob
import json
import os
import time

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit


class Publisher(Unit):
    """Gathers a report from the workflow and renders it.

    kwargs:
    * ``backends`` — iterable of {"markdown", "json", "html"}
      (default ("markdown", "json"));
    * ``directory`` — output dir (default <cache>/reports);
    * ``include_plots`` — link rendered plot pngs (default True).

    Attach result providers via ``result_providers.add(unit)`` (units
    implementing get_metric_names/get_metric_values — decisions and
    evaluators) and the loader via ``loader_unit``.
    """

    BACKENDS = ("markdown", "json", "html")

    def __init__(self, workflow, **kwargs):
        super(Publisher, self).__init__(workflow, **kwargs)
        self.backends = tuple(kwargs.get("backends",
                                         ("markdown", "json")))
        for b in self.backends:
            if b not in self.BACKENDS:
                raise ValueError("unknown publisher backend %r" % (b,))
        self.directory = kwargs.get("directory")
        self.include_plots = kwargs.get("include_plots", True)
        self.result_providers = set()
        self.loader_unit = None
        self.report = None       # last gathered report dict
        self.destinations = []   # files written

    def initialize(self, device=None, **kwargs):
        super(Publisher, self).initialize(device=device, **kwargs)
        if not self.directory:
            self.directory = os.path.join(root.common.dirs.cache,
                                          "reports")
        self._t0 = time.time()

    # -- gathering ----------------------------------------------------------
    def gather(self):
        wf = self.workflow
        report = {
            "workflow": type(wf).__name__,
            "name": getattr(wf, "name", type(wf).__name__),
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
            "elapsed_sec": round(time.time() - self._t0, 3),
            "config": root.as_dict() if hasattr(root, "as_dict") else {},
            "metrics": {},
            "loader": {},
            "unit_timings": [],
            "plots": [],
        }
        for provider in sorted(self.result_providers,
                               key=lambda u: u.name):
            names = provider.get_metric_names()
            values = provider.get_metric_values()
            if isinstance(values, dict):
                metrics = {str(k): values[k] for k in values}
            else:
                metrics = dict(zip(names, values))
            report["metrics"][provider.name] = _plain(metrics)
        ldr = self.loader_unit
        if ldr is not None:
            report["loader"] = _plain({
                "type": type(ldr).__name__,
                "class_lengths": list(getattr(ldr, "class_lengths", ())),
                "epochs": getattr(ldr, "epoch_number", None),
                "minibatch_size": getattr(ldr, "max_minibatch_size", None),
            })
        if hasattr(wf, "unit_timings"):
            report["unit_timings"] = [
                {"unit": u.name, "seconds": round(t, 4), "runs": n}
                for u, t, n in wf.unit_timings()]
        if self.include_plots:
            plot_dir = os.path.join(root.common.dirs.cache, "plots")
            report["plots"] = sorted(glob.glob(
                os.path.join(plot_dir, "*.png")))
        if telemetry.enabled():
            report["telemetry"] = telemetry.merged_snapshot()
        self.report = report
        return report

    # -- rendering ----------------------------------------------------------
    def run(self):
        report = self.gather()
        os.makedirs(self.directory, exist_ok=True)
        del self.destinations[:]
        stamp = time.strftime("%Y%m%d_%H%M%S")
        base = os.path.join(self.directory,
                            "%s_%s" % (report["name"], stamp))
        for backend in self.backends:
            path = getattr(self, "_render_" + backend)(report, base)
            self.destinations.append(path)
            self.info("published %s", path)

    def _render_json(self, report, base):
        path = base + ".json"
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=str)
        return path

    def _render_markdown(self, report, base):
        lines = ["# %s" % report["name"], "",
                 "*%s — %.1fs elapsed*" % (report["time"],
                                           report["elapsed_sec"]), ""]
        for provider, metrics in report["metrics"].items():
            lines += ["## %s" % provider, ""]
            lines += ["| metric | value |", "|---|---|"]
            lines += ["| %s | %s |" % (k, v) for k, v in metrics.items()]
            lines.append("")
        if report["loader"]:
            lines += ["## Data", ""]
            lines += ["| | |", "|---|---|"]
            lines += ["| %s | %s |" % (k, v)
                      for k, v in report["loader"].items()]
            lines.append("")
        if report["unit_timings"]:
            lines += ["## Unit timings", "",
                      "| unit | seconds | runs |", "|---|---|---|"]
            lines += ["| %s | %s | %s |" % (r["unit"], r["seconds"],
                                            r["runs"])
                      for r in report["unit_timings"][:20]]
            lines.append("")
        tel = report.get("telemetry")
        if tel:
            lines += ["## Telemetry", "",
                      "| series | value |", "|---|---|"]
            for k, v in sorted(tel.get("counters", {}).items()):
                lines.append("| %s | %s |" % (k, v))
            for k, v in sorted(tel.get("gauges", {}).items()):
                lines.append("| %s | %s |" % (k, v))
            for k, h in sorted(tel.get("histograms", {}).items()):
                lines.append(
                    "| %s | n=%s p50=%s p99=%s |"
                    % (k, h.get("count"), h.get("p50"), h.get("p99")))
            lines.append("")
        if report["plots"]:
            lines += ["## Plots", ""]
            lines += ["![%s](%s)" % (os.path.basename(p), p)
                      for p in report["plots"]]
            lines.append("")
        path = base + ".md"
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path

    def _render_html(self, report, base):
        md_rows = "".join(
            "<tr><td>%s</td><td><pre>%s</pre></td></tr>" % (p, json.dumps(
                m, indent=1, default=str))
            for p, m in report["metrics"].items())
        html = ("<html><head><title>%s</title></head><body>"
                "<h1>%s</h1><p>%s — %.1fs</p><table border=1>%s</table>"
                "%s</body></html>") % (
            report["name"], report["name"], report["time"],
            report["elapsed_sec"], md_rows,
            "".join('<img src="file://%s" width="400"/>' % p
                    for p in report["plots"]))
        path = base + ".html"
        with open(path, "w") as f:
            f.write(html)
        return path


def _plain(obj):
    """Recursively convert numpy scalars/arrays to JSON-able values."""
    import numpy
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, numpy.ndarray):
        return obj.tolist()
    if isinstance(obj, numpy.generic):
        return obj.item()
    return obj
