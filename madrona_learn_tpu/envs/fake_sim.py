"""Integer-exact fake simulator + fake policy for rollout verification.

Port of the reference test strategy's centerpiece (reference:
tests/test_rollouts.py:202-298): every quantity is int32 and exactly
predictable, the "network" is an integer recurrence whose learnable bias is
set to the policy index, so collected actions/values/rewards/rnn-states can be
recomputed by a closed-form oracle and checked bit-exactly — including that
policy assignments stay constant within an episode.

Fake dynamics:
- obs ``o``: starts at a random int, becomes ``action0 + 1`` each step.
- obs ``c``: per-agent episode step counter, echoed through the action so the
  sim can advance it (the policy must round-trip it faithfully).
- reward: ``action0 + 2``.
- done: when the counter wraps at ``episode_len``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import random

from .. import nn


@dataclass(frozen=True)
class FakeSimConfig:
    batch_size: int
    episode_len: int
    num_teams: int = 1
    team_size: int = 1
    obs_seed: int = 5

    @property
    def agents_per_world(self) -> int:
        return self.num_teams * self.team_size

    @property
    def num_worlds(self) -> int:
        return self.batch_size // self.agents_per_world


def make_fake_sim(cfg: FakeSimConfig):
    """Build ``sim_fns`` implementing the sim contract over fake dynamics."""

    def init_fn():
        obs = {
            "o": random.randint(
                random.PRNGKey(cfg.obs_seed), (cfg.batch_size, 1), 0, 10000),
            "c": jnp.zeros((cfg.batch_size, 1), jnp.int32),
        }
        return {"state": {}, "obs": obs}

    def step_fn(step_input):
        actions = step_input["actions"]["fake"]
        resets = step_input["resets"]  # [num_worlds, 1]

        agent_resets = jnp.repeat(
            resets, cfg.agents_per_world, axis=0).astype(jnp.bool_)

        counter = actions[..., 2:3] + 1
        dones = counter == cfg.episode_len
        counter = counter % cfg.episode_len

        dones = jnp.logical_or(dones, agent_resets)
        counter = jnp.where(agent_resets, 0, counter)

        # Per-world match results: the winning team is just team 0 (enough to
        # drive the episode_results plumbing in tests). Batch-polymorphic
        # (manual collect region runs the step on world-slices).
        num_worlds = actions.shape[0] // cfg.agents_per_world
        episode_results = jnp.zeros((num_worlds, 1), jnp.int32)

        return {
            "state": {},
            "obs": {
                "o": actions[..., 0:1] + 1,
                "c": counter,
            },
            "rewards": actions[..., 0:1] + 2,
            "dones": dones,
            "pbt": {"episode_results": episode_results},
        }

    return {"init": init_fn, "step": step_fn, "data_parallel": True}


class FakeActionDist:
    """Deterministic pass-through 'distribution' for the fake policy."""

    def __init__(self, action):
        self.action = action

    def best(self):
        return self.action

    def sample(self, prng_key):
        return self.action, self.action

    def action_stats(self, actions):
        zeros = jnp.zeros_like(actions)
        return zeros, zeros


class FakeNet(nn.Module):
    """Integer feature net: output encodes (o + bias, bias, counter).

    ``bias`` is the single learnable parameter; tests set it to the policy
    index so actions identify which policy produced them.
    """

    @nn.compact
    def __call__(self, obs, train):
        inputs = obs["o"]
        bias = self.param(
            "bias", jax.nn.initializers.constant(0), (), jnp.int32)
        return jnp.concatenate(
            [
                inputs + bias,
                jnp.broadcast_to(bias[None, None], inputs.shape),
                obs["c"],
            ],
            axis=-1,
        )


class FakeRNN(nn.Module):
    """Integer recurrence: y = x0 + h; h' = h + 2*x0 (exactly recomputable)."""

    def init_recurrent_state(self, N):
        return jnp.zeros((N, 1), jnp.int32)

    def clear_recurrent_state(self, rnn_states, should_clear):
        return jnp.where(should_clear, jnp.zeros((), jnp.int32), rnn_states)

    @nn.compact
    def __call__(self, cur_hiddens, in_features, train):
        y = in_features[..., 0:1] + cur_hiddens
        new_hiddens = cur_hiddens + 2 * in_features[..., 0:1]
        y = jnp.concatenate([y, in_features[..., 1:3], new_hiddens], axis=-1)
        return y, new_hiddens

    def sequence(self, start_hiddens, seq_ends, seq_x, train):
        def step(carry, xs):
            x, end = xs
            y = x[..., 0:1] + carry
            carry = carry + 2 * x[..., 0:1]
            y = jnp.concatenate([y, x[..., 1:3], carry], axis=-1)
            carry = self.clear_recurrent_state(carry, end)
            return carry, y

        _, outputs = jax.lax.scan(step, start_hiddens, (seq_x, seq_ends))
        return outputs


class FakeActor(nn.Module):
    """Action = (rnn_out0, bias, counter): echoes everything the sim needs."""

    @nn.compact
    def __call__(self, features, train=False):
        return FakeActionDist(features[..., 0:3])


class FakeCritic(nn.Module):
    """Value = rnn hidden state (int32, exactly predictable)."""

    @nn.compact
    def __call__(self, features, train=False):
        return features[..., 3:4]
