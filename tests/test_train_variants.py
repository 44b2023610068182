"""Coverage for the remaining algorithm variants: HL-Gauss critics,
advantage filtering, trajectory importance sampling, returns-only mode,
clip/huber value losses, bf16 compute, and continuous action spaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneEncoder,
    BackboneShared,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DictActor,
    HLGaussCritic,
    HLGaussTwoPartCritic,
    MLP,
)
from madrona_learn_tpu.models.critics import DictActor as _DictActor
from madrona_learn_tpu.ops.dists import ContinuousActionDistributions

from test_train_e2e import make_policy


def run_cfg(num_updates=3, num_worlds=32, seed=13, critic=None,
            **cfg_overrides):
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    env_cfg = ToyEnvConfig(num_worlds=num_worlds, episode_len=20,
                           grid_size=5, seed=seed)
    sim_fns = make_toy_env(env_cfg)

    dtype = cfg_overrides.pop("dtype", jnp.float32)

    base = dict(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=num_updates,
        actions=actions,
        steps_per_update=40,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.95,
        gae_lambda=0.95,
        seed=seed,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=2,
            minibatch_size=min(64, 2 * num_worlds),
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
            clip_value_loss=cfg_overrides.pop("clip_value_loss", False),
            huber_value_loss=cfg_overrides.pop("huber_value_loss", False),
        ),
        dreamer_v3_critic=False,
        compute_dtype=dtype,
    )
    base.update(cfg_overrides)
    cfg = mlt.TrainConfig(**base)

    prefix = lambda obs, train: jnp.concatenate(
        [obs["delta"], obs["time"]], axis=-1)
    backbone = BackboneShared(
        prefix=prefix,
        encoder=BackboneEncoder(
            net=MLP(num_channels=32, num_layers=1, dtype=dtype)))
    actor_critic = ActorCritic(
        backbone=backbone,
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(
                cfg=actions["move"], dtype=dtype)}),
        critic=critic if critic is not None else DenseLayerCritic(
            dtype=dtype),
    )
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
    )

    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(num_updates):
        mgr = update(mgr)
    loss = np.asarray(jax.device_get(mgr.metrics.metrics["Loss"].mean))
    assert np.isfinite(loss).all(), f"non-finite loss: {loss}"
    return mgr


def test_hlgauss_critic():
    run_cfg(critic=HLGaussCritic.create(dtype=jnp.float32),
            hlgauss_critic=True)


def test_scalar_critic_with_distributional_flag_raises():
    """dreamer_v3_critic=True + a scalar critic must fail loudly, not
    silently .mean()-collapse the batch into a cryptic GAE scan error."""
    with pytest.raises(TypeError, match="dreamer_v3_critic"):
        run_cfg(num_updates=1, dreamer_v3_critic=True)


def test_hlgauss_two_part_critic():
    run_cfg(critic=HLGaussTwoPartCritic.create(dtype=jnp.float32),
            hlgauss_critic=True)


def test_filter_advantages():
    run_cfg(filter_advantages=True)


def test_importance_sample_trajectories():
    run_cfg(importance_sample_trajectories=True,
            importance_sample_num_minibatches=1,
            num_worlds=64)


def test_returns_only_mode():
    run_cfg(compute_advantages=False, normalize_returns=True)


def test_clip_value_loss():
    run_cfg(clip_value_loss=True)


def test_huber_value_loss():
    run_cfg(huber_value_loss=True)


def test_bf16_compute():
    run_cfg(dtype=jnp.bfloat16)


def test_fp16_dynamic_scale():
    run_cfg(dtype=jnp.float16)


def test_continuous_action_training():
    """Continuous action space end to end (tanh-normal heads)."""
    num_worlds = 32
    actions = {"steer": mlt.ContinuousActionsConfig(
        stddev_min=0.05, stddev_max=0.5, num_dims=2)}
    env_cfg = ToyEnvConfig(num_worlds=num_worlds, episode_len=20,
                           grid_size=5, seed=2)
    base_sim = make_toy_env(env_cfg)

    # Adapt the discrete gridworld: continuous action [2] -> nearest move.
    def step_fn(step_input):
        cont = step_input["actions"]["steer"][:, 0, :]  # [B, 2]
        dx = jnp.where(jnp.abs(cont[:, 0]) > 0.3,
                       jnp.where(cont[:, 0] > 0, 3, 4), 0)
        dy = jnp.where(jnp.abs(cont[:, 1]) > 0.3,
                       jnp.where(cont[:, 1] > 0, 1, 2), 0)
        move = jnp.where(dx > 0, dx, dy).astype(jnp.int32)[:, None]
        inner = dict(step_input)
        inner["actions"] = {"move": move}
        return base_sim["step"](inner)

    sim_fns = {"init": base_sim["init"], "step": step_fn}

    from madrona_learn_tpu import nn

    class SteerActor(nn.Module):
        cfg: mlt.ContinuousActionsConfig

        @nn.compact
        def __call__(self, features, train=False):
            out = nn.Dense(2 * self.cfg.num_dims)(features)
            means = out[..., None, :self.cfg.num_dims]
            stds = out[..., None, self.cfg.num_dims:]
            return ContinuousActionDistributions(
                cfgs=[self.cfg], means=means, stds=stds)

    dtype = jnp.float32
    prefix = lambda obs, train: jnp.concatenate(
        [obs["delta"], obs["time"]], axis=-1)
    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=prefix,
            encoder=BackboneEncoder(
                net=MLP(num_channels=32, num_layers=1, dtype=dtype))),
        actor=DictActor(heads={"steer": SteerActor(cfg=actions["steer"])}),
        critic=DenseLayerCritic(dtype=dtype),
    )
    policy = mlt.Policy(actor_critic=actor_critic)

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=2,
        actions=actions,
        steps_per_update=20,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.95,
        gae_lambda=0.95,
        seed=2,
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
