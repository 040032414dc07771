"""Durable blackbox — crash-safe on-disk persistence for the planes.

Counterpart of ``znicz_tpu/core/blackbox.py``.  The flight-recorder
journal (:mod:`znicz_tpu_torch.core.telemetry`) and the metric
time-series (:mod:`znicz_tpu_torch.core.timeseries`) are rings in
process memory and die with the process; a crash report helps only
when Python runs an excepthook.  This module is the flight recorder
that survives the crash:

* a write-through journal sink: every ``telemetry.record_event`` lands
  on disk when it is emitted (:func:`maybe_arm` installs it);
* time-series checkpoints: every ``checkpoint_every_sweeps``-th
  sampler sweep persists the newest point of every ring, so
  ``rate()`` queries span restarts (:func:`query_rate`);
* segments: length-delimited JSONL files named
  ``<role>.<pid>.<boot>.<nnn>`` under one directory, each record
  ``<len> <json>\\n``, byte for byte the JAX package's format, so
  either package reads the other's segments.  A writer killed
  mid-record leaves a torn tail the reader recovers around (every
  complete record survives; the torn bytes are counted).  Rotation
  closes a segment with an fsync of the file, then of its directory;
  size-based retention deletes the oldest segments first, never the
  live one;
* request traces: every head-sampled tree
  (:mod:`znicz_tpu_torch.serving.reqtrace`) is persisted when it
  closes (:func:`_on_trace`, the reqtrace finish sink); a fleet's
  router tree and replica tree for one rid land in their own
  processes' segments and :func:`query_rid` re-stitches them;
* the query CLI ``python -m znicz_tpu_torch obs`` (:func:`cli_main`):
  the merged cross-process timeline, ``--rid`` following one request,
  ``--rate`` over the checkpoints across restarts and ``--postmortem
  ROLE``; ``GET /debug/blackbox`` on every :class:`~znicz_tpu_torch.
  core.status_server.HandlerBase` server answers the writer's stats.

The writer's lock is a ``locksmith`` lock.

Everything gates on ``root.common.telemetry.blackbox.enabled``: off,
:func:`maybe_arm` returns after one config read, no sink is installed,
no writer exists and nothing touches the filesystem.  Armed, a record
is one unbuffered ``write()`` (no fsync a record: the page cache
survives a SIGKILL; the fsync comes at rotation).
"""

import json
import os
import re
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root

#: the config node (stable object identity — config.py declares it)
_cfg = root.common.telemetry.blackbox

_lock = locksmith.lock("blackbox.writer")

#: lazily created on the first ARMED use — the disabled path never
#: allocates (zero-overhead-off contract)
_writer = None


def enabled():
    """The one gate — a live read of
    ``root.common.telemetry.blackbox.enabled``."""
    return bool(_cfg.get("enabled", False))


def enable(**overrides):
    for k, v in overrides.items():
        setattr(root.common.telemetry.blackbox, k, v)
    root.common.telemetry.blackbox.enabled = True
    return True


def disable():
    root.common.telemetry.blackbox.enabled = False
    return False


def configured_dir():
    """The shared segment directory: the ``dir`` knob, defaulting to
    ``<cache>/blackbox`` (one host, one dir)."""
    return str(_cfg.get("dir", None)
               or os.path.join(root.common.dirs.cache, "blackbox"))


# ---------------------------------------------------------------------------
# Record framing — length-delimited JSONL
# ---------------------------------------------------------------------------
#
# One record = b"<decimal-byte-length> <json-utf8>\n".  The length
# prefix makes the torn-tail test exact: a reader knows precisely how
# many bytes a complete record needs, so a killed writer's partial
# final record is detected (and counted) instead of being half-parsed.

def _frame(record):
    data = json.dumps(record, default=str,
                      separators=(",", ":")).encode("utf-8")
    return b"%d %s\n" % (len(data), data)


def read_segment(path):
    """Recover every complete record of one segment file.

    Returns ``(records, torn_bytes)``: ``records`` is the list of
    decoded dicts, ``torn_bytes`` the length of the truncated /
    corrupt tail a killed writer left (0 for a cleanly closed
    segment).  Tolerates a tail torn ANYWHERE — inside the length
    prefix, the JSON payload, or the trailing newline."""
    with open(path, "rb") as f:
        data = f.read()
    records = []
    pos, end = 0, len(data)
    while pos < end:
        sp = data.find(b" ", pos, pos + 20)
        if sp < 0:
            break  # torn inside (or right after) the length prefix
        try:
            n = int(data[pos:sp])
        except ValueError:
            break  # corrupt length prefix
        start = sp + 1
        stop = start + n
        if stop >= end or data[stop:stop + 1] != b"\n":
            # ">=" not ">": a record missing its newline was torn
            # mid-write — json may parse, durability was not reached
            break
        try:
            records.append(json.loads(data[start:stop].decode("utf-8")))
        except ValueError:
            break  # complete length, corrupt payload: stop loudly
        pos = stop + 1
    return records, end - pos


#: segment file name: <role>.<pid>.<boot>.<nnn> — role may itself be
#: dotted, so pid/boot/seq anchor from the RIGHT
_NAME_RE = re.compile(
    r"^(?P<role>.+)\.(?P<pid>\d+)\.(?P<boot>[0-9a-f]+)\.(?P<seq>\d+)$")


def parse_segment_name(name):
    """``<role>.<pid>.<boot>.<nnn>`` -> dict (None for foreign
    files — the reader skips anything else in a shared dir)."""
    m = _NAME_RE.match(name)
    if m is None:
        return None
    return {"role": m.group("role"), "pid": int(m.group("pid")),
            "boot": m.group("boot"), "seq": int(m.group("seq"))}


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _Writer(object):
    """The armed process's append-only segment writer (all mutation
    under ``_lock``)."""

    def __init__(self, role, directory):
        self.role = str(role)
        self.dir = directory
        self.pid = os.getpid()
        # boot id: wall-clock millis in hex — two boots of the same
        # pid (pid reuse after a crash loop) stay distinguishable
        self.boot = "%x" % int(time.time() * 1e3)
        self.seq = 0
        self.records = 0
        self.bytes_written = 0
        self.rotations = 0
        self.retention_deleted = 0
        self._f = None
        self._seg_bytes = 0

    def segment_name(self, seq=None):
        return "%s.%d.%s.%03d" % (self.role, self.pid, self.boot,
                                  self.seq if seq is None else seq)

    @property
    def current_path(self):
        return os.path.join(self.dir, self.segment_name())

    def _open_segment(self):
        os.makedirs(self.dir, exist_ok=True)
        # buffering=0: each record is ONE os.write straight to the
        # page cache — a SIGKILLed process loses at most the record
        # being written (the torn tail the reader tolerates), never
        # a stdio buffer full of already-"written" history
        self._f = open(self.current_path, "ab", buffering=0)
        self._seg_bytes = 0
        self._append({"bb": "meta", "t": round(time.time(), 6),
                      "role": self.role, "pid": self.pid,
                      "boot": self.boot, "seq": self.seq})

    def _append(self, record):
        line = _frame(record)
        self._f.write(line)
        self._seg_bytes += len(line)
        self.bytes_written += len(line)
        self.records += 1

    def write(self, record):
        with _lock:
            if self._f is None:
                self._open_segment()
            self._append(record)
            if self._seg_bytes >= int(_cfg.get("segment_bytes",
                                               1 << 20)):
                self._rotate()

    def _rotate(self):
        """Close the full segment with the snapshotter's durability
        discipline (fsync the file, then its directory — a finished
        segment must survive power loss, not just process death),
        open the next one, then enforce retention."""
        f, self._f = self._f, None
        os.fsync(f.fileno())
        f.close()
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self.seq += 1
        self.rotations += 1
        self._open_segment()
        self._retain()

    def _retain(self):
        """Size-based oldest-first retention: delete whole segments
        (never the live one) until the dir's total is back under
        ``retention_bytes``."""
        budget = int(_cfg.get("retention_bytes", 64 << 20))
        if budget <= 0:
            return
        live = self.current_path
        entries = []
        total = 0
        for name in os.listdir(self.dir):
            if parse_segment_name(name) is None:
                continue
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            total += st.st_size
            entries.append((st.st_mtime, name, path, st.st_size))
        entries.sort()
        for _, _, path, size in entries:
            if total <= budget:
                break
            if path == live:
                continue  # never delete the segment being written
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            self.retention_deleted += 1

    def close(self):
        with _lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
            f.close()


# ---------------------------------------------------------------------------
# Arming — sink installation into the other planes
# ---------------------------------------------------------------------------

def _on_journal(ev):
    """telemetry journal sink: one event -> one durable record, at
    emit time.  ``slo.burn`` / ``release.*`` / ``autoscaler`` events
    (exemplar rids included) ride through here untouched."""
    w = _writer
    if w is not None:
        w.write(dict(ev, bb="journal"))


def _on_sweep(sweeps, now):
    """timeseries checkpoint sink: every ``checkpoint_every_sweeps``
    sampler sweeps, persist the newest point of every ring."""
    w = _writer
    if w is None:
        return
    every = max(1, int(_cfg.get("checkpoint_every_sweeps", 5)))
    if sweeps % every:
        return
    from znicz_tpu_torch.core import timeseries
    series = timeseries.last_points()
    if series:
        w.write({"bb": "ts", "t": round(float(now), 6),
                 "sweeps": int(sweeps), "series": series})


def _on_trace(rid, tree):
    """reqtrace finish sink: one closed head-sampled tree -> one
    durable record (JAX :319-328)."""
    w = _writer
    if w is not None and tree is not None:
        w.write({"bb": "trace", "t": round(time.time(), 6),
                 "rid": rid, "tree": tree})


def maybe_arm(role=None):
    """Arm the durable blackbox iff the gate is on (idempotent; the
    first arm wins the role).  Called by ``HttpServerBase.start`` and,
    earlier and with an explicit role, by the serve CLI ("serve") and
    the workflow CLI ("train"), so flipping the knob is all an operator
    does.  Effective role: the ``role`` knob over the caller's argument
    over ``"proc"``.  Returns True when a writer is armed after the
    call."""
    if not enabled():
        return False
    global _writer
    with _lock:
        if _writer is None:
            effective = str(_cfg.get("role", None) or role or "proc")
            _writer = _Writer(effective, configured_dir())
    from znicz_tpu_torch.core import telemetry
    from znicz_tpu_torch.core import timeseries
    from znicz_tpu_torch.serving import reqtrace
    telemetry.register_help(
        "blackbox", "durable blackbox (core/blackbox.py): records "
                    "and bytes persisted, rotations, torn tails")
    telemetry.set_journal_sink(_on_journal)
    timeseries.set_checkpoint_sink(_on_sweep)
    reqtrace.set_finish_sink(_on_trace)
    return True


def armed():
    """True while a writer exists (tests + /debug/blackbox)."""
    return _writer is not None


def current_segment():
    """The live segment's path (None when disarmed or before the
    first record) — what ``write_crash_report`` points at so a
    postmortem can jump straight from the crash dir to the durable
    history."""
    w = _writer
    if w is None or w._f is None:
        return None
    return w.current_path


def reset():
    """Close the writer and uninstall every sink (tests)."""
    global _writer
    with _lock:
        w, _writer = _writer, None
    if w is not None:
        w.close()
    from znicz_tpu_torch.core import telemetry
    from znicz_tpu_torch.core import timeseries
    from znicz_tpu_torch.serving import reqtrace
    telemetry.set_journal_sink(None)
    timeseries.set_checkpoint_sink(None)
    reqtrace.set_finish_sink(None)


def stats():
    """The ``GET /debug/blackbox`` payload: gate, writer state, and
    the shared dir's segment inventory."""
    out = {"enabled": enabled(), "armed": _writer is not None}
    w = _writer
    if w is not None:
        out.update({
            "role": w.role, "pid": w.pid, "boot": w.boot,
            "dir": w.dir, "segment": w.segment_name(),
            "segment_bytes": w._seg_bytes,
            "records": w.records,
            "bytes_written": w.bytes_written,
            "rotations": w.rotations,
            "retention_deleted": w.retention_deleted,
        })
    directory = w.dir if w is not None else (
        configured_dir() if enabled() else None)
    if directory and os.path.isdir(directory):
        segments = [n for n in os.listdir(directory)
                    if parse_segment_name(n) is not None]
        out["segments_on_disk"] = len(segments)
        out["total_bytes"] = sum(
            os.stat(os.path.join(directory, n)).st_size
            for n in segments)
    return out


# ---------------------------------------------------------------------------
# Reader — scan, merged timeline, rid reconstruction, postmortem
# ---------------------------------------------------------------------------

def scan(directory):
    """Every segment in ``directory``: a list of
    ``{"path", "role", "pid", "boot", "seq", "bytes"}`` sorted by
    (role, pid, boot, seq).  Foreign files are skipped."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        meta = parse_segment_name(name)
        if meta is None:
            continue
        path = os.path.join(directory, name)
        try:
            meta["bytes"] = os.stat(path).st_size
        except OSError:
            continue
        meta["path"] = path
        out.append(meta)
    out.sort(key=lambda m: (m["role"], m["pid"], m["boot"], m["seq"]))
    return out


def read_all(directory, roles=None):
    """Recover every record in the dir.  Returns
    ``(records, torn)``: ``records`` is a list of
    ``(source_label, record)`` with ``source_label =
    "<role>.<pid>.<boot>"``; ``torn`` maps a segment path to its
    torn-tail byte count (only segments WITH a torn tail appear —
    the caller reports them loudly).  Recovering a torn segment also
    journals a ``blackbox.torn_tail`` event (counted, not silently
    dropped) when a journal is recording in THIS process."""
    records = []
    torn = {}
    for seg in scan(directory):
        if roles and seg["role"] not in roles:
            continue
        source = "%s.%d.%s" % (seg["role"], seg["pid"], seg["boot"])
        try:
            recs, torn_bytes = read_segment(seg["path"])
        except OSError:
            continue  # retention deleted it mid-scan
        if torn_bytes:
            torn[seg["path"]] = torn_bytes
            from znicz_tpu_torch.core import telemetry
            telemetry.counter("blackbox.torn_tails").inc()
            telemetry.record_event("blackbox.torn_tail",
                                   segment=seg["path"],
                                   bytes=torn_bytes)
        for rec in recs:
            records.append((source, rec))
    return records, torn


def timeline(directory, n=0, kind=None, rid=None, roles=None):
    """The merged cross-process journal timeline: every durable
    journal record in the dir, sorted by wall time, each tagged with
    its source.  ``kind`` is a prefix filter (``slo`` matches
    ``slo.burn``), ``rid`` matches any of the rid-bearing fields, and
    ``n`` keeps only the newest N (0 = all)."""
    records, torn = read_all(directory, roles=roles)
    events = []
    for source, rec in records:
        if rec.get("bb") != "journal":
            continue
        if kind and not str(rec.get("kind", "")).startswith(kind):
            continue
        if rid and rid not in (rec.get("rid"), rec.get("exemplar_rid"),
                               rec.get("request_id")):
            continue
        ev = dict(rec, source=source)
        ev.pop("bb", None)
        events.append(ev)
    events.sort(key=lambda e: float(e.get("t", 0.0)))
    if n and n > 0:
        events = events[-n:]
    return {"events": events, "torn": torn}


def query_rid(directory, rid):
    """Follow one request across every process's segments (JAX
    :499-538): its journal events, every persisted trace tree, and —
    when a router tree and a replica tree both survived — the
    re-stitched cross-process trace (``reqtrace.stitch``, what ``GET
    /debug/trace/<rid>`` on the router answered live)."""
    records, torn = read_all(directory)
    events = []
    trees = []  # (source, tree)
    for source, rec in records:
        if rec.get("bb") == "trace" and rec.get("rid") == rid:
            trees.append((source, rec.get("tree") or {}))
        elif rec.get("bb") == "journal" and rid in (
                rec.get("rid"), rec.get("exemplar_rid"),
                rec.get("request_id")):
            ev = dict(rec, source=source)
            ev.pop("bb", None)
            events.append(ev)
    events.sort(key=lambda e: float(e.get("t", 0.0)))
    router = replica = None
    replica_source = None
    for source, tree in trees:
        if tree.get("origin") == "router":
            router = tree
        else:
            replica = tree
            replica_source = source
    stitched = None
    if router is not None and replica is not None:
        from znicz_tpu_torch.serving import reqtrace
        stitched = reqtrace.stitch(router, replica, replica=replica_source)
    return {
        "rid": rid,
        "events": events,
        "traces": [{"source": s, "tree": t} for s, t in trees],
        "stitched": stitched,
        "torn": torn,
    }


def checkpoint_payloads(directory, roles=None):
    """Reassemble every source's timeseries checkpoints into
    snapshot-shaped payloads (``{source: {"series": {name: {"kind",
    "points"}}}}``) — directly mergeable by
    ``timeseries.merge_snapshots``, which is what makes cross-restart
    ``rate()`` work: a dead boot's counter latches at its final value
    in the step-merge while the successor boot's counter sums on
    top, so the merged series stays monotonic across the restart."""
    records, _ = read_all(directory, roles=roles)
    payloads = {}
    for source, rec in records:
        if rec.get("bb") != "ts":
            continue
        payload = payloads.setdefault(
            source, {"enabled": True, "sweeps": 0, "series": {}})
        payload["sweeps"] = max(payload["sweeps"],
                                int(rec.get("sweeps", 0)))
        for name, point in (rec.get("series") or {}).items():
            entry = payload["series"].setdefault(
                name, {"kind": point.get("kind"), "points": []})
            entry["points"].append([float(point.get("t", 0.0)),
                                    float(point.get("v", 0.0))])
    for payload in payloads.values():
        for entry in payload["series"].values():
            entry["points"].sort(key=lambda p: p[0])
    return payloads


def query_rate(directory, series, window_s=None, roles=None):
    """Cross-restart ``rate()``: merge every boot's checkpoints and
    rate the merged ring over the trailing window.  Returns
    ``{"series", "rate", "points", "sources"}`` (rate None when
    underdetermined — fewer than two checkpoints)."""
    from znicz_tpu_torch.core import timeseries
    payloads = checkpoint_payloads(directory, roles=roles)
    merged = timeseries.merge_snapshots(payloads, window_s=window_s)
    block = merged["series"].get(series)
    return {
        "series": series,
        "rate": merged["rates"].get(series),
        "points": block["points"] if block else [],
        "sources": sorted(payloads),
    }


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def postmortem(directory, role, n=40):
    """Bundle a dead process's last segments: pick the newest boot of
    ``role`` whose pid is gone (falling back to the newest boot
    overall when every pid still runs), and return its final journal
    events, last timeseries checkpoint, persisted trace rids, and
    the torn-tail report — the ``obs --postmortem`` payload the
    deployment runbook points an operator at."""
    segs = [s for s in scan(directory) if s["role"] == role]
    if not segs:
        return {"role": role, "error": "no segments for role %r under "
                                       "%s" % (role, directory)}
    boots = {}
    for seg in segs:
        boots.setdefault((seg["pid"], seg["boot"]), []).append(seg)
    dead = [k for k in boots if not _pid_alive(k[0])]
    pool = dead or list(boots)
    pid, boot = max(pool, key=lambda k: k[1])  # boot id is ms-hex
    chosen = boots[(pid, boot)]
    events = []
    last_ckpt = None
    trace_rids = []
    torn = {}
    for seg in chosen:
        recs, torn_bytes = read_segment(seg["path"])
        if torn_bytes:
            torn[seg["path"]] = torn_bytes
        for rec in recs:
            if rec.get("bb") == "journal":
                ev = dict(rec)
                ev.pop("bb", None)
                events.append(ev)
            elif rec.get("bb") == "ts":
                last_ckpt = rec
            elif rec.get("bb") == "trace":
                trace_rids.append(rec.get("rid"))
    events.sort(key=lambda e: float(e.get("t", 0.0)))
    return {
        "role": role, "pid": pid, "boot": boot,
        "alive": _pid_alive(pid),
        "segments": [s["path"] for s in chosen],
        "events": events[-n:],
        "last_checkpoint": last_ckpt,
        "trace_rids": trace_rids,
        "torn": torn,
    }


# ---------------------------------------------------------------------------
# The obs CLI — python -m znicz_tpu_torch obs
# ---------------------------------------------------------------------------

def _print_event(ev):
    extra = {k: v for k, v in ev.items()
             if k not in ("t", "elapsed", "kind", "source")}
    stamp = time.strftime("%H:%M:%S",
                          time.localtime(float(ev.get("t", 0.0))))
    print("%s  %-24s %-20s %s"  # noqa: T201
          % (stamp, ev.get("source", "?"), ev.get("kind", "?"),
             " ".join("%s=%s" % (k, extra[k]) for k in sorted(extra))))


def _print_torn(torn):
    for path, nbytes in sorted(torn.items()):
        print("!! torn tail: %d byte%s of a truncated record "  # noqa
              "at the end of %s (writer killed mid-write; every "
              "complete record above was recovered)"
              % (nbytes, "" if nbytes == 1 else "s", path))


def cli_main(argv=None):
    """``python -m znicz_tpu_torch obs`` — query a blackbox dir across
    process boundaries and restarts."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch obs",
        description="Query the durable blackbox (core/blackbox.py): "
                    "merged cross-process journal timeline, "
                    "cross-restart --rate metric queries, --postmortem "
                    "bundles.")
    parser.add_argument("--dir", default=None,
                        help="blackbox segment dir (default: the "
                             "root.common.telemetry.blackbox.dir "
                             "knob, else <cache>/blackbox)")
    parser.add_argument("-n", type=int, default=50,
                        help="newest N timeline events (0 = all)")
    parser.add_argument("--kind", default=None,
                        help="journal kind prefix filter (e.g. slo "
                             "matches slo.burn)")
    parser.add_argument("--role", action="append", default=None,
                        help="restrict to segments of this role "
                             "(repeatable)")
    parser.add_argument("--rid", default=None,
                        help="follow ONE request: its journal events "
                             "and persisted trace trees, re-stitched "
                             "across the router and the replica")
    parser.add_argument("--rate", metavar="SERIES", default=None,
                        help="cross-restart rate() of a counter "
                             "series from the persisted checkpoints")
    parser.add_argument("--window", type=float, default=None,
                        help="--rate trailing window seconds "
                             "(default: all checkpoints)")
    parser.add_argument("--postmortem", metavar="ROLE", default=None,
                        help="bundle the newest dead boot of ROLE: "
                             "final journal events, last timeseries "
                             "checkpoint, trace rids, torn tails")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    args = parser.parse_args(argv)
    directory = args.dir or configured_dir()
    if not os.path.isdir(directory):
        print("no blackbox dir at %s (arm with --config common."  # noqa: T201
              "telemetry.blackbox.enabled=True)" % directory)
        return 1
    if args.rid:
        out = query_rid(directory, args.rid)
        if args.json:
            print(json.dumps(out, default=str))  # noqa: T201
            return 0
        print("rid %s: %d journal event%s, %d persisted trace "  # noqa: T201
              "tree%s%s"
              % (args.rid, len(out["events"]),
                 "" if len(out["events"]) == 1 else "s",
                 len(out["traces"]),
                 "" if len(out["traces"]) == 1 else "s",
                 ", stitched" if out["stitched"] else ""))
        for ev in out["events"]:
            _print_event(ev)
        tree = out["stitched"] or (out["traces"][-1]["tree"]
                                   if out["traces"] else None)
        if tree:
            print("trace (%s, wall %s ms, complete=%s):"  # noqa: T201
                  % (tree.get("origin"), tree.get("wall_ms"),
                     tree.get("complete")))
            for span in tree.get("spans", ()):
                print("  %8.3f ms  %-14s %8.3f ms  [%s]"  # noqa: T201
                      % (span.get("start_ms", 0.0), span["kind"],
                         span.get("duration_ms", 0.0),
                         span.get("process", "serving")))
        _print_torn(out["torn"])
        return 0
    if args.rate:
        out = query_rate(directory, args.rate, window_s=args.window,
                         roles=args.role)
        if args.json:
            print(json.dumps(out, default=str))  # noqa: T201
            return 0
        if out["rate"] is None:
            print("%s: rate underdetermined (%d checkpointed "  # noqa: T201
                  "point%s across %d source%s)"
                  % (args.rate, len(out["points"]),
                     "" if len(out["points"]) == 1 else "s",
                     len(out["sources"]),
                     "" if len(out["sources"]) == 1 else "s"))
            return 1
        print("%s: %.6g/s over %d merged point%s from %s"  # noqa: T201
              % (args.rate, out["rate"], len(out["points"]),
                 "" if len(out["points"]) == 1 else "s",
                 ", ".join(out["sources"])))
        return 0
    if args.postmortem:
        out = postmortem(directory, args.postmortem, n=args.n)
        if args.json:
            print(json.dumps(out, default=str))  # noqa: T201
            return 0
        if out.get("error"):
            print(out["error"])  # noqa: T201
            return 1
        print("postmortem %s pid %d boot %s (%s): %d segment%s"  # noqa: T201
              % (out["role"], out["pid"], out["boot"],
                 "still alive" if out["alive"] else "dead",
                 len(out["segments"]),
                 "" if len(out["segments"]) == 1 else "s"))
        for ev in out["events"]:
            _print_event(dict(ev, source="%s.%d" % (out["role"],
                                                    out["pid"])))
        if out["last_checkpoint"]:
            ck = out["last_checkpoint"]
            print("last checkpoint: sweep %s, %d series"  # noqa: T201
                  % (ck.get("sweeps"), len(ck.get("series") or ())))
        if out["trace_rids"]:
            print("persisted trace rids: %s"  # noqa: T201
                  % ", ".join(str(r) for r in out["trace_rids"]))
        _print_torn(out["torn"])
        return 0
    out = timeline(directory, n=args.n, kind=args.kind,
                   rid=args.rid, roles=args.role)
    if args.json:
        print(json.dumps(out, default=str))  # noqa: T201
        return 0
    for ev in out["events"]:
        _print_event(ev)
    _print_torn(out["torn"])
    return 0
