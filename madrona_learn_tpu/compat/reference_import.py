"""Import trained checkpoints from the reference framework.

The reference (shacklettbp/madrona-learn) and this framework share linen
param layouts for every module family EXCEPT the LSTM: the reference
trains through flax's ``nn.OptimizedLSTMCell`` with eight per-gate denses
(``ii/if/ig/io`` input kernels, no bias; ``hi/hf/hg/ho`` recurrent kernels
with biases — reference: rnn.py:29-41), while this framework packs gates
``(i, f, g, o)`` along one axis with a single fused bias
(models/lstm.py:_PackedLSTMLayer) so the sequence pass can hoist the input
projection out of the time scan. The packed math is identical:

    input_proj/kernel = concat(ii, if, ig, io)   # [F, 4H]
    recurrent_kernel  = concat(hi, hf, hg, ho)   # [H, 4H]
    bias              = concat(b_hi, b_hf, b_hg, b_ho)

(the reference adds the h-side biases only; the i-side denses are
bias-free, so the packed bias equals the sum of all per-gate biases).

``convert_reference_params`` rewrites any pytree containing reference
LSTM subtrees (``.../rnn/cell/OptimizedLSTMCell_<i>/...`` →
``.../rnn/layer_<i>/...``) and passes every other leaf through unchanged —
MLPs, LayerNorms, actor heads, critics, and EMA observation-normalizer
state already match leaf-for-leaf (verified by
tests/test_reference_import.py against the actually-running reference).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

_GATE_ORDER = ("i", "f", "g", "o")
# Containers convertible to the packed layout: the reference's
# ``cell/OptimizedLSTMCell_<i>`` nesting, plus this repo's own
# pre-restructure LSTM (``cell/layer_<i>`` holding the same eight per-gate
# denses) so old local checkpoints keep loading after the packed-gate
# restructure.
_CELL_PREFIXES = ("OptimizedLSTMCell_", "layer_")


def _is_ref_lstm_cell(subtree: Any) -> bool:
    return (isinstance(subtree, Mapping)
            and all(f"i{g}" in subtree and f"h{g}" in subtree
                    for g in _GATE_ORDER))


def _pack_ref_lstm_cell(cell: Mapping[str, Any]) -> dict:
    # np (host-side) on purpose: conversion is pure array shuffling over a
    # possibly-large checkpoint; don't stage it onto an accelerator.
    input_kernel = np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATE_ORDER],
        axis=-1)
    recurrent_kernel = np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATE_ORDER],
        axis=-1)
    bias = np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATE_ORDER])
    for g in _GATE_ORDER:  # the i-side denses are bias-free by design
        if "bias" in cell[f"i{g}"]:
            raise ValueError(
                f"unexpected input-dense bias on gate '{g}': the "
                "reference's OptimizedLSTMCell has none (rnn.py:29-36); "
                "this checkpoint came from a modified reference and would "
                "lose those biases if packed")
    return {
        "input_proj": {"kernel": input_kernel},
        "recurrent_kernel": recurrent_kernel,
        "bias": bias,
    }


def _cell_layer_idx(key: str):
    """Layer index if ``key`` names a per-layer cell, else None."""
    for prefix in _CELL_PREFIXES:
        if key.startswith(prefix) and key[len(prefix):].isdigit():
            return int(key[len(prefix):])
    return None


def _is_ref_lstm_cell_container(value: Any) -> bool:
    """A ``cell`` subtree whose children are all per-gate-dense LSTM layers
    (reference ``OptimizedLSTMCell_<i>`` or this repo's pre-restructure
    ``layer_<i>`` naming)."""
    return (isinstance(value, Mapping) and value
            and all(isinstance(k, str) and _cell_layer_idx(k) is not None
                    and _is_ref_lstm_cell(v)
                    for k, v in value.items()))


def convert_reference_params(params: Any) -> Any:
    """Rewrite a reference param pytree into this framework's layout.

    Works on the ``{'params': ...}`` variables dict, a bare params dict,
    or any enclosing pytree (e.g. a whole policy-state dict); every
    non-LSTM leaf passes through unchanged. The ``cell`` nesting level is
    collapsed ONLY when it verifiably contains OptimizedLSTMCell subtrees
    (our LSTM declares ``layer_<i>`` directly on the module).
    """
    if not isinstance(params, Mapping):
        return params

    converted = {}
    for key, value in params.items():
        if key == "cell" and _is_ref_lstm_cell_container(value):
            for cell_key, cell in value.items():
                layer_idx = _cell_layer_idx(cell_key)
                converted[f"layer_{layer_idx}"] = _pack_ref_lstm_cell(cell)
        else:
            converted[key] = convert_reference_params(value)
    return converted


def import_reference_checkpoint(ckpt_dir: str) -> dict:
    """Restore a reference orbax checkpoint directory and convert every
    param tree inside to this framework's layout.

    Returns the restored pytree with all LSTM subtrees repacked; callers
    slice out ``policy_states``/``params`` as needed (the reference's
    checkpoint layout is its ``TrainStateManager`` pytree, reference:
    train_state.py:145-196).
    """
    import os

    import orbax.checkpoint as ocp

    ckpt_dir = os.path.abspath(ckpt_dir)
    restored = ocp.PyTreeCheckpointer().restore(ckpt_dir)
    return convert_reference_params(restored)
