"""On-device Welford metrics with a per-policy ring buffer.

Capability parity with the reference metrics system (reference:
metrics.py:12-244): each ``Metric`` tracks mean / m2 / min / max / count as a
pytree so it can be recorded from inside the jitted train step; merges use the
parallel-Welford combine so partial metrics computed per-shard reduce exactly.
``TrainingMetrics`` holds a FrozenDict of metrics in a ring buffer of
``buffer_size`` updates, expanded per-policy for vmapped recording.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..struct import FrozenDict, PyTreeNode, field


_F32_MAX = float(np.finfo(np.float32).max)
_F32_MIN = float(np.finfo(np.float32).min)


class Metric(PyTreeNode):
    per_policy: bool = field(pytree_node=False)
    mean: jax.Array
    m2: jax.Array
    min: jax.Array
    max: jax.Array
    count: jax.Array

    @staticmethod
    def init(per_policy: bool) -> "Metric":
        return Metric(
            per_policy=per_policy,
            mean=jnp.float32(0),
            m2=jnp.float32(0),
            min=jnp.float32(_F32_MAX),
            max=jnp.float32(_F32_MIN),
            count=jnp.int32(0),
        )

    @staticmethod
    def init_from_data(per_policy: bool, data) -> "Metric":
        mean = jnp.mean(data, dtype=jnp.float32)
        deltas = data.astype(jnp.float32) - mean
        return Metric(
            per_policy=per_policy,
            mean=mean,
            m2=jnp.sum(deltas * deltas, dtype=jnp.float32),
            min=jnp.min(data).astype(jnp.float32),
            max=jnp.max(data).astype(jnp.float32),
            count=jnp.int32(data.size),
        )

    @staticmethod
    def init_from_data_masked(per_policy: bool, data, mask) -> "Metric":
        """Welford stats over only the elements where ``mask`` is true."""
        mask = mask.astype(jnp.bool_)
        count = jnp.sum(mask, dtype=jnp.int32)
        safe_count = jnp.maximum(count, 1).astype(jnp.float32)
        data_f = data.astype(jnp.float32)
        zeros = jnp.zeros_like(data_f)
        masked = jnp.where(mask, data_f, zeros)
        mean = jnp.sum(masked) / safe_count
        deltas = jnp.where(mask, data_f - mean, zeros)
        return Metric(
            per_policy=per_policy,
            mean=mean,
            m2=jnp.sum(deltas * deltas),
            min=jnp.min(jnp.where(mask, data_f, _F32_MAX)),
            max=jnp.max(jnp.where(mask, data_f, _F32_MIN)),
            count=count,
        )

    def reset(self) -> "Metric":
        return Metric(
            per_policy=self.per_policy,
            mean=jnp.zeros_like(self.mean),
            m2=jnp.zeros_like(self.m2),
            min=jnp.full_like(self.min, _F32_MAX),
            max=jnp.full_like(self.max, _F32_MIN),
            count=jnp.zeros_like(self.count),
        )

    def merge(self, other: "Metric") -> "Metric":
        """Parallel-Welford combine; exact under any partitioning of the data."""
        new_count = self.count + other.count
        delta = other.mean - self.mean
        safe_denom = 1.0 / jnp.maximum(new_count.astype(jnp.float32), 1)

        mean = self.mean + delta * other.count.astype(jnp.float32) * safe_denom
        m2 = (
            self.m2
            + other.m2
            + delta
            * delta
            * self.count.astype(jnp.float32)
            * other.count.astype(jnp.float32)
            * safe_denom
        )
        return self.replace(
            mean=mean,
            m2=m2,
            min=jnp.minimum(self.min, other.min),
            max=jnp.maximum(self.max, other.max),
            count=new_count,
        )

    def merge_across(self, axis_name) -> "Metric":
        """Exact parallel-Welford combine across a shard_map mesh axis.

        The grouped form of ``merge``: global mean is the count-weighted
        mean of shard means, and the global m2 adds each shard's
        between-group term ``count * (mean - global_mean)^2``. Used when
        metrics are recorded from per-shard slices inside a manual region
        so every shard ends with identical (replicated) statistics.
        """
        count = jax.lax.psum(self.count, axis_name)
        count_f = count.astype(jnp.float32)
        safe = jnp.maximum(count_f, 1.0)
        mean = jax.lax.psum(
            self.mean * self.count.astype(jnp.float32), axis_name) / safe
        m2 = jax.lax.psum(
            self.m2
            + self.count.astype(jnp.float32) * jnp.square(self.mean - mean),
            axis_name)
        return self.replace(
            mean=mean,
            m2=m2,
            min=jax.lax.pmin(self.min, axis_name),
            max=jax.lax.pmax(self.max, axis_name),
            count=count,
        )


class TrainingMetrics(PyTreeNode):
    metrics: FrozenDict
    update_idx: jax.Array
    cur_buffer_offset: jax.Array
    update_buffer_size: jax.Array
    print_names: FrozenDict = field(pytree_node=False)

    @staticmethod
    def create(
        metrics: Dict[str, Metric],
        buffer_size: int,
        start_update_idx: int,
        num_policies: int,
    ) -> "TrainingMetrics":
        metrics = FrozenDict(metrics)

        def expand_metric(m):
            @partial(jax.vmap, in_axes=None, out_axes=0, axis_size=num_policies)
            def expand_policy(x):
                return x

            @partial(jax.vmap, in_axes=None, out_axes=0, axis_size=buffer_size)
            def expand_time(x):
                return x

            m = expand_time(m)
            if m.per_policy:
                m = expand_policy(m)
            return m

        return TrainingMetrics(
            metrics=FrozenDict({k: expand_metric(v) for k, v in metrics.items()}),
            update_idx=jnp.full((num_policies,), start_update_idx, jnp.int32),
            cur_buffer_offset=jnp.zeros((num_policies,), jnp.int32),
            update_buffer_size=jnp.full((num_policies,), buffer_size, jnp.int32),
            print_names=FrozenDict({k: k for k in metrics.keys()}),
        )

    def update_metrics(self, metrics) -> "TrainingMetrics":
        """Write pre-built Metric values into the current ring-buffer slot."""
        updated = {}
        for k in metrics.keys():
            updated[k] = jax.tree.map(
                lambda x, y: x.at[:, self.cur_buffer_offset].set(y),
                self.metrics[k],
                metrics[k],
            )
        return self.replace(metrics=self.metrics.copy(updated))

    def record(self, data, axis_name=None, masks=None) -> "TrainingMetrics":
        """Summarize raw arrays into Metrics and store them.

        Handles both the vmapped (inside per-policy ``vmap``; arrays have no
        policy axis and the stored metric slot is 1-D) and the unvmapped case
        (policy leading axis). With ``axis_name`` (inside a shard_map region
        where each shard recorded stats over its slice of the batch), the
        per-shard Welford summaries are combined exactly across the axis so
        the stored metric equals the single-device one. ``masks`` (a dict
        keyed like ``data``; entries broadcastable to their array, 1 = real
        and 0 = padding) restricts the statistics to real elements — used
        when minibatch rows are zero-padded to divide over mesh row shards.
        """
        updated = {}
        for k in data.keys():
            per_policy = self.metrics[k].per_policy
            mask = masks.get(k) if masks is not None else None

            def init_metric_one(arr, per_policy=per_policy, mask=mask):
                if mask is not None:
                    m = Metric.init_from_data_masked(
                        per_policy, arr, jnp.broadcast_to(mask, arr.shape))
                else:
                    m = Metric.init_from_data(per_policy, arr)
                if axis_name is not None:
                    m = m.merge_across(axis_name)
                return m

            init_metric = init_metric_one
            if per_policy and self.metrics[k].mean.ndim > 1:
                init_metric = jax.vmap(init_metric_one)
                write = lambda x, y: x.at[:, self.cur_buffer_offset].set(y)
            else:
                write = lambda x, y: x.at[self.cur_buffer_offset].set(y)

            updated[k] = jax.tree.map(write, self.metrics[k], init_metric(data[k]))
        return self.replace(metrics=self.metrics.copy(updated))

    def advance(self) -> "TrainingMetrics":
        return self.replace(
            update_idx=self.update_idx + 1,
            cur_buffer_offset=(self.cur_buffer_offset + 1) % self.update_buffer_size,
        )

    # -- host-side reporting -------------------------------------------------

    def pretty_print(self, tab=2):
        """Print the most recently recorded buffer slot per metric."""
        tab = " " * tab
        buf_size = int(np.asarray(self.update_buffer_size).reshape(-1)[0])
        last = (int(np.asarray(self.cur_buffer_offset).reshape(-1)[0])
                - 1) % buf_size

        lines = [tab + "TrainingMetrics"]
        for k, name in self.print_names.items():
            m = self.metrics[k]

            def slot(x):
                x = np.asarray(x)
                # [buffer] or [policies, buffer] -> latest slot value(s).
                return x[..., last]

            def fmt(x):
                x = np.atleast_1d(slot(x))
                return ", ".join(f"{float(v): .3e}" for v in x)

            with np.errstate(invalid="ignore", divide="ignore"):
                stddev = np.sqrt(np.asarray(m.m2) / np.asarray(m.count))
            lines.append(tab * 2 + f"{name}:")
            lines.append(tab * 3 + f"Avg: {fmt(m.mean)}")
            lines.append(tab * 3 + f"Min: {fmt(m.min)}")
            lines.append(tab * 3 + f"Max: {fmt(m.max)}")
            lines.append(tab * 3 + f"sigma: {fmt(stddev)}")
        print("\n".join(lines))

    def tensorboard_log(self, base_update_idx, writer):
        for buf_idx in range(int(self.update_buffer_size[0])):
            out_idx = base_update_idx + buf_idx
            for name, metric in self.metrics.items():
                if not metric.per_policy:
                    stddev = np.sqrt(metric.m2[buf_idx] / metric.count[buf_idx])
                    writer.scalar(f"{name} Mean", metric.mean[buf_idx], out_idx)
                    writer.scalar(f"{name} sigma", stddev, out_idx)
                    writer.scalar(f"{name} Min", metric.min[buf_idx], out_idx)
                    writer.scalar(f"{name} Max", metric.max[buf_idx], out_idx)
                else:
                    for i in range(metric.mean.shape[0]):
                        stddev = np.sqrt(
                            metric.m2[i, buf_idx] / metric.count[i, buf_idx])
                        writer.scalar(
                            f"p{i}/{name} Mean", metric.mean[i, buf_idx], out_idx)
                        writer.scalar(f"p{i}/{name} sigma", stddev, out_idx)
                        writer.scalar(
                            f"p{i}/{name} Min", metric.min[i, buf_idx], out_idx)
                        writer.scalar(
                            f"p{i}/{name} Max", metric.max[i, buf_idx], out_idx)
