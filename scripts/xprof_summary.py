"""Summarize an XProf capture: per-op-family device self-time.

Every ``jax.profiler`` capture writes a Chrome trace next to its xplane;
this tool computes nesting-aware SELF time per kernel on the device lanes
(the GPU's CUDA streams) and aggregates by op family — in-context
attribution, unlike standalone sub-program timings, which see other
layouts and pay their own dispatch.

Usage:
    python benchmarks/profile_update.py          # writes artifacts/xprof/
    python scripts/xprof_summary.py [trace_dir] [--top 20]

Takes the newest ``*trace.json.gz`` under the dir (default
artifacts/xprof/).
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys


def load_events(trace_file):
    with gzip.open(trace_file) as fh:
        data = json.load(fh)
    events = data.get("traceEvents", [])
    # Device processes are named /device:<PLATFORM>:<id>.
    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dev_pids = {p for p, n in pids.items() if n.startswith("/device:")}
    lanes = {
        (e["pid"], e["tid"]): e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    # GPU kernels run on "Stream #..." lanes; other devices have one
    # "XLA Ops" lane.
    op_lanes = {k for k, n in lanes.items()
                if k[0] in dev_pids and ("XLA Ops" in n or "Stream" in n)}
    return [e for e in events
            if e.get("ph") == "X" and (e["pid"], e.get("tid")) in op_lanes]


def self_times(events):
    """Nesting-aware self time per op name (children subtracted).

    Stacked PER (pid, tid) lane: on multi-device traces, concurrent ops
    from different lanes are not each other's children — one global stack
    would subtract device B's time from device A's enclosing op. An event
    counts as a child only when it lies wholly inside the enclosing one:
    consecutive GPU kernels on a stream can overlap by a few hundred
    nanoseconds in the trace without nesting."""
    out = collections.Counter()
    by_lane = collections.defaultdict(list)
    for e in events:
        by_lane[(e["pid"], e.get("tid"))].append(e)
    for lane_events in by_lane.values():
        stack = []
        for e in sorted(lane_events, key=lambda e: (e["ts"], -e.get("dur", 0))):
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and stack[-1][1] <= ts:
                stack.pop()
            if stack and ts + dur <= stack[-1][1]:
                out[stack[-1][2]] -= dur
            elif stack:
                stack.pop()
            out[e["name"]] += dur
            stack.append((ts, ts + dur, e["name"]))
    return out


# jax named_scope labels used across the codebase (train/rollouts/ppo/
# models); op_name metadata paths are matched against these to attribute
# device self-time to semantic cost centers. Order matters only for
# display; matching keeps the DEEPEST scope on the path.
PROFILE_SCOPES = (
    "Update Iter", "Collect Rollouts", "Update Observations Stats",
    "Learn", "Set New Policy States",
    # rollout loop
    "Policy Inference", "Gather Chunk Weights", "Reorder To Policy",
    "Obs Preprocess", "Policy Apply", "Reorder To Sim",
    "Rollout Step", "Sim Step", "Matchmaking", "Compute Reorder State",
    "Pre Step Rollout Store", "Post Step Rollout Store", "Cache RNN state",
    "Bootstrap Values", "Finalize Rollouts",
    # learn phase
    "AC Forward", "rnn.fwd_sequence", "Optimize", "Record Metrics",
    "Compute Minibatch Indices", "Gather Minibatch", "Metrics Callback",
)

_METADATA_RE = re.compile(
    r"%?([\w.-]+) = .*metadata=\{[^}]*op_name=\"([^\"]+)\"")


def load_hlo_scopes(hlo_path):
    """Map HLO instruction name -> named-scope path from op_name metadata.

    The scope path keeps only PROFILE_SCOPES components of the op_name
    (jit wrappers, while/body frames, and transform decorations are
    dropped), joined by '/'. Instructions without a recognized scope map
    to '(no scope)'."""
    scopes = {}
    with open(hlo_path) as f:
        for line in f:
            m = _METADATA_RE.search(line)
            if not m:
                continue
            name, op_name = m.group(1), m.group(2)
            parts = [p for p in op_name.split("/")
                     if any(s in p for s in PROFILE_SCOPES)]
            scope = "/".join(parts) if parts else "(no scope)"
            scopes[name] = scope
            # GPU kernel names spell the instruction's dots as underscores.
            scopes[name.replace(".", "_")] = scope
    return scopes


def scope_attribution(per_op, scopes):
    """Aggregate self time by named-scope path (joined via the HLO map).

    Trace event names are HLO instruction names; events not found in the
    map (infeed, host transfers, renamed modules) land in '(unmapped)'."""
    agg = collections.Counter()
    counts = collections.Counter()
    for name, dur in per_op.items():
        scope = scopes.get(name)
        if scope is None:
            # Fused instruction names sometimes print without the module
            # prefix or with a ".clone" suffix; retry the stem.
            scope = scopes.get(name.split(" ")[0], "(unmapped)")
        agg[scope] += dur
        counts[scope] += 1
    return agg, counts


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("trace_dir", nargs="?", default="artifacts/xprof")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--hlo", default=None,
                        help="optimized HLO text of the profiled program "
                             "(e.g. artifacts/xprof_pbt/hlo.txt); adds a "
                             "named-scope attribution table")
    args = parser.parse_args()

    traces = sorted(glob.glob(
        os.path.join(args.trace_dir, "**", "*trace.json.gz"),
        recursive=True))
    if not traces:
        print(f"no *.trace.json.gz under {args.trace_dir}", file=sys.stderr)
        sys.exit(1)
    trace = traces[-1]
    print(f"trace: {trace}")

    events = load_events(trace)
    if not events:
        print("no device XLA-Ops events found", file=sys.stderr)
        sys.exit(1)
    per_op = self_times(events)

    groups, counts = collections.Counter(), collections.Counter()
    for name, dur in per_op.items():
        fam = re.sub(r"[.\d]+$", "", name)
        groups[fam] += dur
        counts[fam] += 1
    total = sum(groups.values())

    print(f"device self-time total: {total / 1e3:.2f} ms "
          f"({len(events)} op events)")
    print(f"{'ms':>9}  {'share':>6}  {'count':>6}  op family")
    for fam, dur in groups.most_common(args.top):
        print(f"{dur / 1e3:9.3f}  {100 * dur / total:5.1f}%  "
              f"{counts[fam]:6d}  {fam[:80]}")
    print("\ntop single ops:")
    for name, dur in per_op.most_common(args.top // 2):
        print(f"{dur / 1e3:9.3f} ms  {name[:100]}")

    if args.hlo:
        scopes = load_hlo_scopes(args.hlo)
        agg, counts = scope_attribution(per_op, scopes)
        mapped = sum(v for k, v in agg.items()
                     if k not in ("(unmapped)", "(no scope)"))
        print(f"\nnamed-scope attribution (HLO op_name join; "
              f"{100 * mapped / max(total, 1):.1f}% of device time mapped):")
        print(f"{'ms':>9}  {'share':>6}  {'ops':>5}  scope path")
        for scope, dur in agg.most_common(args.top * 2):
            print(f"{dur / 1e3:9.3f}  {100 * dur / total:5.1f}%  "
                  f"{counts[scope]:5d}  {scope[:90]}")


if __name__ == "__main__":
    main()
