"""Device time, host time and idle gaps by the program's spans.

The program marks its modules and phases with ``egc.*`` ranges
(``egc_tpu_torch/utils/profiling.py``: ``span``). Under a profiler each
is a host event, and each device operation links to the host operation
that launched it. This module charges every device operation to a span:

- a kernel counts under the innermost span around the host operation
  that launched it;
- autograd runs a backward node outside the forward's spans (on the
  card, on its own thread). A node carries the profiler's forward link,
  its ``sequence_nr`` and ``fwd_thread``, which match the forward
  operation that recorded it; what the node launches counts under that
  operation's span;
- time that reaches only a span of ``UNOWNED`` (``egc.step``,
  ``egc.forward``, ``egc.backward``), or no span, or no host operation
  (``UNLINKED``), is unattributed.

Each idle gap between device operations is put down, by the same rules,
to the host operation running when the gap begins (the latest-starting
one, as ``trace.idle_gaps`` finds it).

The functions of a record (``module_ms``, ``unattributed_share``,
``host_share``) read the keys a traced run's records would carry:
``profile.span_device_s`` and ``profile.span_gaps`` of the profiled
stretch of ``full``, and ``span_host_s`` (``{name: [seconds, count]}``)
of ``span_totals()`` over the window of a traced ``trial``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from torch.autograd import DeviceType

PREFIX = "egc."
UNOWNED = ("egc.step", "egc.forward", "egc.backward")
NO_SPAN = "(no span)"
UNLINKED = "(unlinked)"


def is_module(name: str) -> bool:
    """Whether time under ``name`` is attributed: an ``egc.*`` span other
    than those of ``UNOWNED``."""
    return name.startswith(PREFIX) and name not in UNOWNED


def _host_events(events) -> list:
    return [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async]


def _device_events(events) -> list:
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _is_backward_node(evt) -> bool:
    return evt.fwd_thread > 0 and evt.sequence_nr >= 0


def span_resolver(events) -> Callable[[object], str]:
    """``span_of(host event)``: the span its time counts under by the
    rules above (a span's name, one of ``UNOWNED`` or ``NO_SPAN``)."""
    host = sorted(_host_events(events), key=lambda e: e.time_range.start)
    forward = {}                  # (thread, sequence_nr) -> forward op
    for e in host:                # the last to start is the node's maker
        if e.sequence_nr >= 0 and not _is_backward_node(e):
            forward[(e.thread, e.sequence_nr)] = e
    memo: Dict[int, str] = {}

    def span_of(evt) -> str:
        seen = []
        name, node = NO_SPAN, evt
        while node is not None:
            if id(node) in memo:
                name = memo[id(node)]
                break
            seen.append(node)
            if node.name.startswith(PREFIX):
                name = node.name
                break
            if _is_backward_node(node):
                fwd = forward.get((node.fwd_thread, node.sequence_nr))
                name = NO_SPAN if fwd is None or fwd is node \
                    else span_of(fwd)
                break
            node = node.cpu_parent
        for n in seen:
            memo[id(n)] = name
        return name

    return span_of


def _seconds(evt) -> float:
    return (evt.time_range.end - evt.time_range.start) / 1e6


def _is_runtime(evt) -> bool:
    """A call into CUDA's own libraries (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...), not an operation of the program."""
    n = evt.name
    return n.startswith("cuda") or (n[:2] == "cu" and n[2:3].isupper())


def launches(events) -> List[Tuple[object, float]]:
    """``[(host operation or None, device seconds)]`` of every device
    operation, by the operation that launched it (None: not found).

    Where the profiler's events carry ``linked_correlation_id``, each
    device event names its host operation. Before that (torch 2.11),
    each host operation lists the device operations linked to it in
    ``kernels``: those are taken, less the user ranges' device marks and
    what runtime calls list, and the rest of the busy time is left with
    no host operation."""
    kernels = _device_events(events)
    if not kernels:
        return []
    host = _host_events(events)
    if all(hasattr(k, "linked_correlation_id") for k in kernels):
        by_id = {e.id: e for e in host if e.linked_correlation_id == 0}
        return [(by_id.get(k.linked_correlation_id), _seconds(k))
                for k in kernels]
    marks = {e.name for e in events if e.device_type == DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)}
    out = [(e, k.duration / 1e6) for e in host if not _is_runtime(e)
           for k in getattr(e, "kernels", ()) if k.name not in marks]
    rest = sum(_seconds(k) for k in kernels) - sum(s for _, s in out)
    return out + [(None, max(rest, 0.0))]


def device_by_span(prof) -> Dict[str, float]:
    """Device seconds of the profiled stretch by span (with the
    unattributed keys as they occur); their sum is the busy time of
    ``trace.profile_record``."""
    events = prof.events()
    span_of = span_resolver(events)
    out: Dict[str, float] = defaultdict(float)
    for launcher, seconds in launches(events):
        out[UNLINKED if launcher is None else span_of(launcher)] += seconds
    return {k: v for k, v in out.items() if v > 0}


def host_self_by_span(prof, prefix: str = "aten::") -> Dict[str, float]:
    """Host self seconds of the operations named ``prefix*`` by span (the
    CPU's counterpart of ``device_by_span``)."""
    events = prof.events()
    span_of = span_resolver(events)
    out: Dict[str, float] = defaultdict(float)
    for e in _host_events(events):
        if e.name.startswith(prefix):
            out[span_of(e)] += e.self_cpu_time_total / 1e6
    return dict(out)


def gaps_by_span(prof, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle seconds between its operations by the span of
    the host operation running when each gap begins, the largest first."""
    events = prof.events()
    dev = sorted((k.time_range.start, k.time_range.end)
                 for k in _device_events(events))
    if not dev:
        return []
    span_of = span_resolver(events)
    host = sorted(_host_events(events), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by: Dict[str, float] = defaultdict(float)
    end = dev[0][1]
    for a, b in dev[1:]:
        if a > end:
            name = NO_SPAN
            for i in range(bisect.bisect_right(starts, end) - 1, -1, -1):
                if host[i].time_range.end > end:
                    name = span_of(host[i])
                    break
            by[name] += (a - end) / 1e6
        end = max(end, b)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def unattributed(by_span: Dict[str, float]) -> float:
    """The seconds of ``by_span`` that no module span owns."""
    return sum(v for k, v in by_span.items() if not is_module(k))


# ---------------------------------------------------------------------------
# per-layer numbers of a run's records
# ---------------------------------------------------------------------------

def module_ms(r: dict, name: str) -> Optional[float]:
    """Device ms a step under span ``name`` (forward and backward) in a
    traced ``full`` run; None without the spans' record."""
    prof = r.get("profile") if r.get("mode") == "full" else None
    if not prof or "span_device_s" not in prof:
        return None
    return 1e3 * prof["span_device_s"].get(name, 0.0) / prof["steps"]


def unattributed_share(r: dict) -> Optional[float]:
    """The % of the device's busy time in a traced ``full`` run that no
    module span owns."""
    prof = r.get("profile") if r.get("mode") == "full" else None
    if not prof or "span_device_s" not in prof:
        return None
    by = prof["span_device_s"]
    return 100.0 * unattributed(by) / max(sum(by.values()), 1e-30)


def host_share(r: dict, name: str) -> Optional[float]:
    """The % of a traced ``trial`` window's iteration seconds spent under
    span ``name`` on the host."""
    if r.get("mode") != "trial" or "span_host_s" not in r:
        return None
    return 100.0 * r["span_host_s"].get(name, [0.0, 0])[0] / r["window_s"]
