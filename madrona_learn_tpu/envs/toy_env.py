"""Learnable pure-JAX toy environments implementing the sim contract.

Used by the end-to-end training tests and the benchmark harness (the
reference has no in-repo env at all; its tests use fake dynamics and the real
engine is an external C++/CUDA simulator — reference: rollouts.py:905-947).

Two variants:

- ``make_toy_env`` (single-team): a target-chasing gridworld. Obs are the
  egocentric delta to a target; the 5 discrete actions move the agent;
  reward is the decrease in L1 distance plus a bonus for sitting on the
  target. PPO should push mean episode return up within a handful of updates.

- competitive mode (``num_teams=2``): a per-world bidding duel — each agent
  bids via its action; the team whose summed bids are higher wins the episode
  reward. Per-episode ``episode_results`` report the winning team, driving the
  Elo machinery. A policy with a genuinely better (higher-bid) strategy wins
  deterministically, so fitness ordering is testable.

Everything is shape-static, vectorized over the full sim batch, and sharded
along the batch axis for free when the train step runs over a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
from jax import random


@dataclass(frozen=True)
class ToyEnvConfig:
    num_worlds: int
    episode_len: int = 40
    grid_size: int = 8
    num_teams: int = 1
    team_size: int = 1
    seed: int = 0
    reward_dtype: jnp.dtype = jnp.float32

    @property
    def agents_per_world(self) -> int:
        return self.num_teams * self.team_size

    @property
    def batch_size(self) -> int:
        return self.num_worlds * self.agents_per_world


# numpy (not jnp) so importing this module never initializes a backend —
# multi-host programs must call jax.distributed.initialize first.
_MOVES = np.array(
    [[0, 0], [0, 1], [0, -1], [1, 0], [-1, 0]], dtype=np.int32)


_SALTS_POS = np.uint32([[0x27D4EB2F, 0x165667B1]])
_SALTS_TGT = np.uint32([[0x85EBCA77, 0xC2B2AE3D]])


def _hash_draw2(base, salts, grid_size):
    """Two per-row pseudo-random ints in [0, grid) from a base hash.

    A stateless function of (base[B,1], salt[1,2]), so it is
    SLICE-EQUIVARIANT: row i of a batch-wide evaluation equals the same
    row evaluated inside any contiguous slice — the property the manual
    collect region needs from a data-parallel sim (a single batch PRNG
    key would draw different values per slice shape). Toy-env-grade
    statistical quality, tuned for the rollout hot loop: one shared
    multiply-xor chain, salts broadcast over the last axis (no
    concatenate), and a multiply-shift range map instead of an integer
    modulo. The hash runs on every rollout step, so its op count shows
    up end to end.
    """
    h = base ^ jnp.asarray(salts)  # [B, 2]
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 13)
    # Multiply-shift onto [0, grid): top 16 hash bits scaled down.
    return (((h >> 16) * jnp.uint32(grid_size)) >> 16).astype(jnp.int32)


def make_toy_env(cfg: ToyEnvConfig):
    """Build ``sim_fns`` for the target-chasing gridworld.

    The step function is batch-polymorphic and per-row independent
    (``data_parallel``): every per-row quantity derives from the row's own
    state (including respawn draws, via a counter-based hash of the row id
    and a never-reset tick), so the manual collect region can run it on
    world-slices with slice-invariant results.
    """

    B = cfg.batch_size

    def _obs(pos, target, t):
        delta = (target - pos).astype(jnp.float32) / cfg.grid_size
        t_frac = t.astype(jnp.float32) / cfg.episode_len
        return {
            "delta": delta,
            "time": t_frac,
        }

    def init_fn():
        key = random.PRNGKey(cfg.seed)
        k_pos, k_tgt = random.split(key, 2)
        pos = random.randint(k_pos, (B, 2), 0, cfg.grid_size)
        target = random.randint(k_tgt, (B, 2), 0, cfg.grid_size)
        t = jnp.zeros((B, 1), jnp.int32)
        rid = jnp.arange(B, dtype=jnp.int32)[:, None]
        tick = jnp.zeros((B, 1), jnp.int32)
        state = {"pos": pos, "target": target, "t": t,
                 "rid": rid, "tick": tick}
        return {"state": state, "obs": _obs(pos, target, t)}

    def step_fn(step_input):
        state = step_input["state"]
        action = step_input["actions"]["move"][..., 0]  # [B]
        resets = step_input["resets"]  # [num_worlds, 1]

        pos, target, t = state["pos"], state["target"], state["t"]
        rid, tick = state["rid"], state["tick"]

        old_dist = jnp.sum(jnp.abs(target - pos), axis=-1, keepdims=True)
        moves = jnp.asarray(_MOVES)
        new_pos = jnp.clip(pos + moves[action], 0, cfg.grid_size - 1)
        new_dist = jnp.sum(jnp.abs(target - new_pos), axis=-1, keepdims=True)

        on_target = (new_dist == 0)
        reward = (
            (old_dist - new_dist).astype(jnp.float32)
            + jnp.where(on_target, 1.0, 0.0)
        ).astype(cfg.reward_dtype)

        t = t + 1
        tick = tick + 1
        episode_over = t >= cfg.episode_len
        agent_resets = jnp.repeat(
            resets, cfg.agents_per_world, axis=0).astype(jnp.bool_)
        dones = jnp.logical_or(episode_over, agent_resets)

        # Respawn finished agents at fresh pseudo-random positions: a
        # stateless hash of (row id, tick) — per-row independent, so the
        # step slices cleanly over the batch (see _hash_draw2).
        base = (jnp.uint32(cfg.seed)
                ^ (rid.astype(jnp.uint32) * jnp.uint32(0x9E3779B1))
                ^ (tick.astype(jnp.uint32) * jnp.uint32(0x85EBCA77)))
        respawn_pos = _hash_draw2(base, _SALTS_POS, cfg.grid_size)
        respawn_tgt = _hash_draw2(base, _SALTS_TGT, cfg.grid_size)

        pos = jnp.where(dones, respawn_pos, new_pos)
        target = jnp.where(dones, respawn_tgt, target)
        t = jnp.where(dones, 0, t)

        new_state = {"pos": pos, "target": target, "t": t,
                     "rid": rid, "tick": tick}
        num_worlds = action.shape[0] // cfg.agents_per_world
        episode_results = jnp.zeros((num_worlds, 1), jnp.int32)

        return {
            "state": new_state,
            "obs": _obs(pos, target, t),
            "rewards": reward,
            "dones": dones,
            "pbt": {"episode_results": episode_results},
        }

    # Sim-state snapshot support (contract: rollouts get_ckpts/load_ckpts;
    # reference: rollouts.py:300-309). Functional-sim variant: state flows
    # through the call. Checkpoints are flat int32 rows [pos, target, t].
    def get_ckpts_fn(sim_state):
        return jnp.concatenate(
            [sim_state["pos"], sim_state["target"], sim_state["t"]],
            axis=-1).astype(jnp.int32)

    def load_ckpts_fn(trigger, ckpts):
        pos = ckpts[:, 0:2]
        target = ckpts[:, 2:4]
        t = ckpts[:, 4:5]
        n = ckpts.shape[0]
        state = {"pos": pos, "target": target, "t": t,
                 "rid": jnp.arange(n, dtype=jnp.int32)[:, None],
                 "tick": jnp.zeros((n, 1), jnp.int32)}
        return {"state": state, "obs": _obs(pos, target, t)}

    return {"init": init_fn, "step": step_fn,
            "get_ckpts": get_ckpts_fn, "load_ckpts": load_ckpts_fn,
            "data_parallel": True}


def make_duel_env(cfg: ToyEnvConfig):
    """Two-team bidding duel for Elo / matchmaking tests.

    Each step every agent 'bids' its discrete action value; at episode end the
    team with the higher summed bids wins (+1 / -1 reward split at the final
    step). ``episode_results`` encode the winning team per world.
    """
    assert cfg.num_teams == 2
    B = cfg.batch_size
    A = cfg.agents_per_world

    def _obs(t, acc):
        return {
            "time": t.astype(jnp.float32) / cfg.episode_len,
            "acc": acc.astype(jnp.float32) / (cfg.episode_len * 4),
        }

    def init_fn():
        t = jnp.zeros((B, 1), jnp.int32)
        acc = jnp.zeros((B, 1), jnp.int32)
        return {"state": {"t": t, "acc": acc}, "obs": _obs(t, acc)}

    def step_fn(step_input):
        state = step_input["state"]
        action = step_input["actions"]["move"][..., 0:1]  # [B, 1], 0..4
        resets = step_input["resets"]

        t, acc = state["t"], state["acc"]
        acc = acc + action
        t = t + 1
        episode_over = t >= cfg.episode_len
        agent_resets = jnp.repeat(resets, A, axis=0).astype(jnp.bool_)
        dones = jnp.logical_or(episode_over, agent_resets)

        # Per-world team sums: [num_worlds, num_teams] (batch-polymorphic
        # so the manual collect region can run the step on world-slices)
        team_acc = acc.reshape(-1, cfg.num_teams, cfg.team_size)
        team_sums = team_acc.sum(axis=-1)
        team0_wins = team_sums[:, 0] > team_sums[:, 1]
        draw = team_sums[:, 0] == team_sums[:, 1]

        # Reward only at episode end: +1 winner / -1 loser, 0 draw.
        team_reward = jnp.where(
            draw[:, None], 0.0, jnp.where(team0_wins[:, None],
                                          jnp.array([[1.0, -1.0]]),
                                          jnp.array([[-1.0, 1.0]])))
        agent_reward = jnp.repeat(
            team_reward.reshape(-1, 1), cfg.team_size, axis=0)
        reward = jnp.where(
            episode_over, agent_reward, 0.0).astype(cfg.reward_dtype)

        # episode_results: winning team index per world (-1 for draw).
        episode_results = jnp.where(
            draw, -1, jnp.where(team0_wins, 0, 1)).astype(jnp.int32)[:, None]

        t = jnp.where(dones, 0, t)
        acc = jnp.where(dones, 0, acc)

        return {
            "state": {"t": t, "acc": acc},
            "obs": _obs(t, acc),
            "rewards": reward,
            "dones": dones,
            "pbt": {"episode_results": episode_results},
        }

    return {"init": init_fn, "step": step_fn, "data_parallel": True}
