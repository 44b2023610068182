"""Collectives of a compiled program, read from its optimized HLO text.

Used by tests/test_sharding.py to assert structural communication rules
of the sharded update step: which mesh axis each all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute runs over, in which phase
of the step (from the op_name scopes), and how many loop trips it executes.
"""

import re

import numpy as np

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


def shape_bytes(shape_text: str) -> int:
    """Total bytes of an HLO result type (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


def parse_replica_groups(line: str, num_devices: int):
    """Groups of device ids from either HLO replica_groups syntax."""
    m = re.search(r"replica_groups=\{\{([^}]*(?:\},\{[^}]*)*)\}\}", line)
    if m:
        return [frozenset(int(x) for x in grp.split(",") if x)
                for grp in m.group(1).split("},{")]
    # Iota form: [G,N]<=[d0,d1,...]T(p0,p1,...)
    m = re.search(
        r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?",
        line)
    if m:
        g, n = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            perm = [int(x) for x in m.group(4).split(",")]
            ids = ids.transpose(perm)
        ids = ids.reshape(g, n)
        return [frozenset(int(x) for x in row) for row in ids]
    return None


def parse_permute_pairs(line: str):
    m = re.search(r"source_target_pairs=\{([^a-z]*?)\}, ", line)
    if not m:
        return None
    pairs = re.findall(r"\{(\d+),(\d+)\}", m.group(1))
    return [(int(a), int(b)) for a, b in pairs]


def mesh_axis_groups(data: int, policy: int, model: int = 1):
    """Device-id groups per mesh axis (mirrors parallel.mesh.make_mesh's
    row-major grid: id = (d * policy + p) * model + m)."""
    grid = np.arange(data * policy * model).reshape(data, policy, model)
    groups = {}
    groups["data"] = [frozenset(grid[:, p, m].tolist())
                      for p in range(policy) for m in range(model)]
    groups["policy"] = [frozenset(grid[d, :, m].tolist())
                        for d in range(data) for m in range(model)]
    groups["model"] = [frozenset(grid[d, p, :].tolist())
                       for d in range(data) for p in range(policy)]
    groups["full-mesh"] = [frozenset(grid.reshape(-1).tolist())]
    return groups


def classify_axis(groups, axis_groups):
    """Name the mesh axis whose groups match; 'mixed' otherwise."""
    gset = set(groups)
    for name, ref in axis_groups.items():
        # Singleton groups (size-1 mesh axes) are no-op collectives.
        if all(len(g) == 1 for g in ref):
            continue
        if gset <= set(ref):
            return name
    return "mixed"


def classify_permute_axis(pairs, axis_groups):
    for name, ref in axis_groups.items():
        if all(len(g) == 1 for g in ref):
            continue
        lookup = {}
        for g in ref:
            for dev in g:
                lookup[dev] = g
        if all(lookup.get(a) is lookup.get(b) for a, b in pairs):
            return name
    return "mixed"


def phase_of(op_name: str) -> str:
    for phase in ("Collect Rollouts", "Update Observations Stats",
                  "Learn", "Set New Policy States"):
        if phase in op_name:
            return phase
    return "other"


def loop_multiplicity(op_name: str, phase: str, cfg_static) -> int:
    whiles = op_name.count("while/body")
    c = cfg_static
    if phase == "Collect Rollouts":
        if whiles >= 2:
            return c["steps_per_update"]
        if whiles == 1:
            return c["num_bptt_chunks"]
        return 1
    if phase == "Learn":
        if whiles >= 2:
            return c["num_epochs"] * c["num_minibatches"]
        if whiles == 1:
            return c["num_epochs"]
        return 1
    return 1


def parse_collectives(hlo: str, data: int, policy: int, static_loops):
    """Every collective in the optimized HLO text as an analysis row.

    ``static_loops`` supplies the loop trip counts the HLO text does not
    expose (see ``loop_multiplicity``): a dict with steps_per_update,
    num_bptt_chunks, num_epochs, num_minibatches.
    """
    num_devices = data * policy
    axis_groups = mesh_axis_groups(data, policy)

    rows = []
    for line in hlo.splitlines():
        m = re.match(
            r"\s*%?[\w.-]+ = ((?:\([^)]*\)|\S+)) (" +
            "|".join(COLLECTIVE_KINDS) + r")\(", line)
        if not m:
            continue
        shape_text, kind = m.group(1), m.group(2)
        # all-*-start/done variants are matched by prefix; skip the *-done
        # halves (the start row carries the shape).
        gbytes_shard_or_global = shape_bytes(shape_text)
        op_name_m = re.search(r'op_name="([^"]*)"', line)
        op_name = op_name_m.group(1) if op_name_m else ""
        phase = phase_of(op_name)
        mult = loop_multiplicity(op_name, phase, static_loops)

        if kind == "collective-permute":
            pairs = parse_permute_pairs(line) or []
            axis = classify_permute_axis(pairs, axis_groups)
            group_size = num_devices  # unused for permute traffic
            shard_bytes = gbytes_shard_or_global  # result = one shard
            global_bytes = shard_bytes * max(len(pairs), 1)
        else:
            groups = parse_replica_groups(line, num_devices)
            if not groups:
                axis, group_size = "unknown", num_devices
            else:
                axis = classify_axis(groups, axis_groups)
                group_size = len(next(iter(groups)))
            if kind == "all-gather":
                # result type is the GLOBAL (gathered) shape
                global_bytes = gbytes_shard_or_global
                shard_bytes = global_bytes // max(group_size, 1)
            elif kind == "reduce-scatter":
                # result is the per-shard shape
                shard_bytes = gbytes_shard_or_global
                global_bytes = shard_bytes * group_size
            else:  # all-reduce / all-to-all: result = input = global
                global_bytes = gbytes_shard_or_global
                shard_bytes = global_bytes // max(group_size, 1)

        rows.append({
            "kind": kind, "shape": shape_text, "axis": axis,
            "phase": phase, "group_size": group_size,
            "global_bytes": global_bytes, "shard_bytes": shard_bytes,
            "mult": mult,
            "op_name": op_name[:160],
        })
    return rows
