"""ActorCritic module and backbone composition.

Capability parity with the reference actor-critic layer (reference:
actor_critic.py:13-303): an ``ActorCritic`` module exposing four apply
methods — ``rollout`` (sample/argmax actions + value), ``update`` (sequence
forward scoring stored actions), ``actor_only`` and ``critic_only`` — over
pluggable backbones.

Backbones are organized as *towers*: a shared obs prefix feeds one
(``BackboneShared``) or two (``BackboneSeparate``) encoder towers whose
outputs drive the actor and critic heads. Encoders are either feed-forward
(``BackboneEncoder``, empty recurrent state) or recurrent
(``RecurrentBackboneEncoder``: net -> rnn, with a time-axis ``sequence``
path for BPTT). Recurrent-state init/clear are plain methods, callable on
the unbound module, so the rollout engine owns state placement (sim-order, batch-leading — see
models/lstm.py).
"""

from __future__ import annotations

from typing import Callable, Union

import jax

from .. import nn
from ..struct import FrozenDict
from ..utils.profile import profile


def _merge_time(tree, T, N):
    """[T*N, ...] -> [T, N, ...] on every leaf."""
    return jax.tree.map(lambda x: x.reshape(T, N, *x.shape[1:]), tree)


def _drop_time(tree):
    """[T, N, ...] -> [T*N, ...] on every leaf."""
    return jax.tree.map(lambda x: x.reshape(-1, *x.shape[2:]), tree)


class Backbone(nn.Module):
    """Interface: __call__ -> (actor_feats, critic_feats, rnn_out);
    actor_only / critic_only -> (feats, rnn_out); sequence -> per-timestep
    (actor_feats, critic_feats) for stored [T, N] batches."""

    def _flatten_obs_sequence(self, obs):
        return _drop_time(obs)

    def init_recurrent_state(self, N):
        raise NotImplementedError

    def clear_recurrent_state(self, recurrent_states, should_clear):
        raise NotImplementedError


class ActorCritic(nn.Module):
    backbone: Backbone
    actor: nn.Module
    critic: nn.Module

    def init_recurrent_state(self, N):
        return self.backbone.init_recurrent_state(N)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.backbone.clear_recurrent_state(
            recurrent_states, should_clear)

    # -- single-step paths (rollout-time) ------------------------------------

    def rollout(self, prng_key, rnn_states_in, obs_in, train=False,
                sample_actions=True, return_debug=False):
        actor_feats, critic_feats, rnn_out = self.backbone(
            rnn_states_in, obs_in, train=train)

        dists = self.actor(actor_feats, train=train)
        if sample_actions:
            actions, log_probs = dists.sample(prng_key)
            results = {"actions": actions, "log_probs": log_probs}
        else:
            results = {"actions": dists.best()}
        results["critic"] = self.critic(critic_feats, train=train)

        return FrozenDict(results), rnn_out

    def actor_only(self, rnn_states_in, obs_in, train=False):
        feats, rnn_out = self.backbone.actor_only(
            rnn_states_in, obs_in, train=train)
        dists = self.actor(feats, train=train)
        return FrozenDict({"actions": dists.best()}), rnn_out

    def critic_only(self, rnn_states_in, obs_in, train=False):
        feats, rnn_out = self.backbone.critic_only(
            rnn_states_in, obs_in, train=train)
        return (
            FrozenDict({"critic": self.critic(feats, train=train)}),
            rnn_out,
        )

    # -- sequence path (update-time) -----------------------------------------

    def update(self, rnn_states, sequence_breaks, rollout_actions, obs,
               train=True):
        """Score stored [T, N] sequences: log-probs + entropies of the taken
        actions and fresh critic outputs, all time-major."""
        T, N = sequence_breaks.shape[0:2]

        actor_feats, critic_feats = self.backbone.sequence(
            rnn_states, sequence_breaks, obs, train=train)

        dists = self.actor(actor_feats, train=train)
        log_probs, entropies = dists.action_stats(
            _drop_time(rollout_actions))
        critic_out = self.critic(critic_feats, train=train)

        return FrozenDict({
            "log_probs": _merge_time(log_probs, T, N),
            "entropies": _merge_time(entropies, T, N),
            "critic": _merge_time(critic_out, T, N),
        })


# ---------------------------------------------------------------------------
# Encoder towers
# ---------------------------------------------------------------------------

class BackboneEncoder(nn.Module):
    """Feed-forward tower; recurrent state is the empty tuple."""

    net: nn.Module

    def init_recurrent_state(self, N):
        return ()

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return ()

    def __call__(self, rnn_states, inputs, train):
        return self.net(inputs, train=train), ()

    def sequence(self, rnn_start_states, sequence_ends, flattened_inputs,
                 train):
        return self.net(flattened_inputs, train=train)


class RecurrentBackboneEncoder(nn.Module):
    """net -> rnn tower with a scan-based sequence path for BPTT."""

    net: nn.Module
    rnn: nn.Module
    # Rematerialize the trunk net in the update-pass backward instead of
    # stashing its intermediate activations (jax.checkpoint; recomputes the
    # net forward during the backward, trading matmul work for activation
    # memory traffic). For activation-heavy trunks (wide/deep MLPs, large
    # entity encoders) where the stash dominates; numerics are unchanged
    # either way (update == no-remat update, asserted on CPU).
    remat_trunk_sequence: bool = False

    def init_recurrent_state(self, N):
        return self.rnn.init_recurrent_state(N)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.rnn.clear_recurrent_state(recurrent_states, should_clear)

    def __call__(self, rnn_states_in, *inputs, train):
        features = self.net(*inputs, train=train)
        return self.rnn(rnn_states_in, features, train)

    def sequence(self, rnn_start_states, sequence_ends, flattened_inputs,
                 train):
        # Features are computed over the flat [T*N] batch (one big matmul),
        # then reshaped to [T, N] for the recurrent scan.
        T, N = sequence_ends.shape[0:2]
        if self.remat_trunk_sequence and not self.is_initializing():
            net_out = jax.checkpoint(
                lambda x: self.net(x, train=train))(flattened_inputs)
        else:
            net_out = self.net(flattened_inputs, train=train)
        features_seq = _merge_time(net_out, T, N)

        with profile("rnn.fwd_sequence"):
            rnn_out = self.rnn.sequence(
                rnn_start_states, sequence_ends, features_seq, train=train)

        return _drop_time(rnn_out)


# ---------------------------------------------------------------------------
# Backbones: prefix + 1 or 2 towers
# ---------------------------------------------------------------------------

class BackboneShared(Backbone):
    """One tower feeds both heads."""

    prefix: Union[nn.Module, Callable]
    encoder: nn.Module

    def init_recurrent_state(self, N):
        return self.encoder.init_recurrent_state(N)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.encoder.clear_recurrent_state(
            recurrent_states, should_clear)

    def __call__(self, rnn_states_in, obs_in, train):
        feats, rnn_out = self.encoder(
            rnn_states_in, self.prefix(obs_in, train=train), train=train)
        return feats, feats, rnn_out

    def actor_only(self, rnn_states_in, obs_in, train):
        return self.encoder(
            rnn_states_in, self.prefix(obs_in, train=train), train=train)

    critic_only = actor_only

    def sequence(self, rnn_start_states, sequence_ends, obs_in, train):
        processed = self.prefix(
            self._flatten_obs_sequence(obs_in), train=train)
        feats = self.encoder.sequence(
            rnn_start_states, sequence_ends, processed, train=train)
        return feats, feats


class BackboneSeparate(Backbone):
    """Independent actor and critic towers over a shared prefix.

    Recurrent state is the tuple (actor_tower_state, critic_tower_state);
    the *_only paths advance just their tower's slot.
    """

    prefix: Union[nn.Module, Callable]
    actor_encoder: nn.Module
    critic_encoder: nn.Module

    def _towers(self):
        return (self.actor_encoder, self.critic_encoder)

    def init_recurrent_state(self, N):
        return tuple(t.init_recurrent_state(N) for t in self._towers())

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return tuple(
            t.clear_recurrent_state(s, should_clear)
            for t, s in zip(self._towers(), recurrent_states))

    def __call__(self, rnn_states_in, obs_in, train):
        processed = self.prefix(obs_in, train=train)
        actor_feats, actor_rnn = self.actor_encoder(
            rnn_states_in[0], processed, train=train)
        critic_feats, critic_rnn = self.critic_encoder(
            rnn_states_in[1], processed, train=train)
        return actor_feats, critic_feats, (actor_rnn, critic_rnn)

    def _one_tower(self, slot, rnn_states_in, obs_in, train):
        processed = self.prefix(obs_in, train=train)
        tower = (self.actor_encoder, self.critic_encoder)[slot]
        feats, rnn_out = tower(rnn_states_in[slot], processed, train=train)
        new_states = list(rnn_states_in)
        new_states[slot] = rnn_out
        return feats, tuple(new_states)

    def actor_only(self, rnn_states_in, obs_in, train):
        return self._one_tower(0, rnn_states_in, obs_in, train)

    def critic_only(self, rnn_states_in, obs_in, train):
        return self._one_tower(1, rnn_states_in, obs_in, train)

    def sequence(self, rnn_start_states, sequence_ends, obs_in, train):
        processed = self.prefix(
            self._flatten_obs_sequence(obs_in), train=train)
        actor_feats = self.actor_encoder.sequence(
            rnn_start_states[0], sequence_ends, processed, train=train)
        critic_feats = self.critic_encoder.sequence(
            rnn_start_states[1], sequence_ends, processed, train=train)
        return actor_feats, critic_feats
