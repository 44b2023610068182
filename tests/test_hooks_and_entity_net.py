"""User hooks (custom state, custom metrics, reward rewriting) and the
entity self-attention backbone end to end."""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneEncoder,
    BackboneShared,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DictActor,
    EntitySelfAttentionNet,
)
from madrona_learn_tpu.ops.metrics import Metric


@dataclass(frozen=True)
class CountingHooks(mlt.TrainHooks):
    """Counts rollout phases in user state; doubles all rewards; records a
    custom metric."""

    def init_user_state(self):
        return {"rollout_count": jnp.zeros((), jnp.int32)}

    def start_rollouts(self, rollout_state, user_state):
        user_state = {"rollout_count": user_state["rollout_count"] + 1}
        return rollout_state, user_state

    def finish_rollouts(self, rollouts, bootstrap_values, unnorm_values,
                        unnorm_bootstrap, user_state):
        rollouts = rollouts.copy(
            {"rewards": rollouts["rewards"] * 2.0})
        return rollouts, user_state

    def add_metrics(self, metrics):
        return metrics.copy({"Custom": Metric.init(True)})

    def rollout_metrics(self, metrics, rollouts, user_state):
        return metrics.record({"Custom": rollouts["rewards"]})


@pytest.mark.slow
def test_hooks_flow():
    num_worlds = 16
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=10, grid_size=5, seed=6))

    from test_train_e2e import make_policy

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=2,
        actions=actions,
        steps_per_update=8,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.95,
        gae_lambda=0.95,
        seed=6,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=2 * num_worlds,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    mgr = mlt.init_training(
        None, cfg, sim_fns, make_policy(actions),
        init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        user_hooks=CountingHooks())

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(2):
        mgr = update(mgr)

    # User state was threaded through and incremented per update.
    assert int(mgr.state.user_state["rollout_count"]) == 2

    # Custom metric recorded, equals 2x the Rewards metric (doubled rewards
    # feed both, since 'Rewards' records post-hook values).
    custom = jax.device_get(mgr.metrics.metrics["Custom"])
    assert int(np.asarray(custom.count).reshape(-1)[0]) > 0


@pytest.mark.slow
def test_entity_attention_backbone_trains():
    """Entity self-attention net over a dict of entity sets, end to end."""
    num_worlds = 16
    dtype = jnp.float32
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    base = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=10, grid_size=5, seed=9))

    # Wrap the toy env's obs into an entity-set structure.
    def wrap_obs(obs):
        self_feat = jnp.concatenate([obs["delta"], obs["time"]], axis=-1)
        entities = jnp.stack(
            [jnp.concatenate([obs["delta"], obs["time"]], -1)] * 3, axis=-2)
        return {"self": self_feat, "landmarks": entities}

    def init_fn():
        out = base["init"]()
        return {"state": out["state"], "obs": wrap_obs(out["obs"])}

    def step_fn(step_input):
        out = base["step"](step_input)
        out["obs"] = wrap_obs(out["obs"])
        return out

    sim_fns = {"init": init_fn, "step": step_fn}

    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: obs,
            encoder=BackboneEncoder(
                net=EntitySelfAttentionNet(
                    num_embed_channels=32,
                    num_out_channels=32,
                    num_heads=2,
                    dtype=dtype,
                )),
        ),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DenseLayerCritic(dtype=dtype),
    )
    policy = mlt.Policy(actor_critic=actor_critic)

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=2,
        actions=actions,
        steps_per_update=8,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.95,
        gae_lambda=0.95,
        seed=9,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=2 * num_worlds,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(2):
        mgr = update(mgr)
    loss = np.asarray(jax.device_get(mgr.metrics.metrics["Loss"].mean))
    assert np.isfinite(loss).all()
