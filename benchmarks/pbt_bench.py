"""PBT population training throughput (BASELINE config #4 shape).

8 train + 4 past policies, 2-team duel env, 25/50/25 self/cross/past play,
full update (complex-matchmaking rollouts + vmapped per-policy PPO).

Run: python benchmarks/pbt_bench.py
"""

import sys, time

sys.path.insert(0, ".")
import jax, jax.numpy as jnp, numpy as np
import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu.models import (
    ActorCritic, BackboneShared, DenseLayerCritic, DenseLayerDiscreteActor,
    DictActor, LSTM, MLP, RecurrentBackboneEncoder)

NUM_TRAIN, NUM_PAST = 8, 4
NUM_WORLDS = 16384
STEPS = 32
CH = 256
dtype = jnp.bfloat16

actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
sim_fns = make_duel_env(ToyEnvConfig(
    num_worlds=NUM_WORLDS, episode_len=32, num_teams=2, team_size=1, seed=0,
    reward_dtype=jnp.float32))

ac = ActorCritic(
    backbone=BackboneShared(
        prefix=lambda obs, train: jnp.concatenate([obs["time"], obs["acc"]], -1),
        encoder=RecurrentBackboneEncoder(
            net=MLP(num_channels=CH, num_layers=2, dtype=dtype),
            rnn=LSTM(num_hidden_channels=CH, num_layers=1, dtype=dtype))),
    actor=DictActor(heads={"move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype)}),
    critic=DenseLayerCritic(dtype=dtype))
policy = mlt.Policy(
    actor_critic=ac,
    obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
    get_episode_scores=lambda er: (
        jnp.where(er[0]==0, 1.0, jnp.where(er[0]==1, 0.0, 0.5)),
        jnp.where(er[0]==0, 0.0, jnp.where(er[0]==1, 1.0, 0.5))))

# train agents/policy: (8192 + 16384/2 + 8192/2)/8 = 2560; seqs = 2*2560=5120/policy
cfg = mlt.TrainConfig(
    num_worlds=NUM_WORLDS, num_agents_per_world=2, num_updates=10,
    actions=actions, steps_per_update=STEPS, num_bptt_chunks=2,
    lr=1e-3, gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
    algo=mlt.PPOConfig(num_epochs=1, minibatch_size=2560, clip_coef=0.2,
        value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
    pbt=mlt.PBTConfig(num_teams=2, team_size=1,
        num_train_policies=NUM_TRAIN, num_past_policies=NUM_PAST,
        self_play_portion=0.25, cross_play_portion=0.5, past_play_portion=0.25),
    dreamer_v3_critic=False, compute_dtype=dtype)

t0=time.perf_counter()
mgr = mlt.init_training(None, cfg, sim_fns, policy,
    init_sim_ctrl=jnp.zeros((1,), jnp.int32))
print(f"init {time.perf_counter()-t0:.0f}s", flush=True)
update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
t0=time.perf_counter()
mgr = update(mgr)
jax.device_get(mgr.metrics.metrics["Loss"].mean)
print(f"compile {time.perf_counter()-t0:.0f}s", flush=True)
t0=time.perf_counter()
for _ in range(10):
    mgr = update(mgr)
jax.device_get(mgr.metrics.metrics["Loss"].mean)
dt = time.perf_counter()-t0
steps = NUM_WORLDS*2*STEPS*10
print(f"PBT {NUM_TRAIN}+{NUM_PAST} policies, {NUM_WORLDS*2} agents: "
      f"{steps/dt/1e6:.2f}M agent-steps/s ({dt/10*1e3:.0f} ms/update)", flush=True)

# --- Elo tournament-step micro-bench (32 policies) -------------------------
# The per-step cost inside eval_elo's rollout loop; round 3 replaced the
# per-policy scan-every-match formulation with a one-hot segment reduction.
from madrona_learn_tpu.pbt import PBTMatchmakeConfig, pbt_update_elo

P_ELO = 32
mm = PBTMatchmakeConfig.setup(
    num_current_policies=P_ELO, num_past_policies=0, num_teams=2, team_size=1,
    sim_batch_size=NUM_WORLDS * 2, self_play_portion=0.0,
    cross_play_portion=1.0, past_play_portion=0.0, static_play_portion=0.0)
rng = np.random.default_rng(0)
M = mm.num_total_matches
asn = jnp.asarray(np.repeat(rng.integers(0, P_ELO, (M, 2)), 1, 1).reshape(-1))
dns = jnp.asarray((rng.random(M * 2) < 0.1).reshape(-1, 1))
ers = jnp.asarray(rng.integers(0, 3, (M, 1)).astype(np.int32))
elos = jnp.full((P_ELO,), 1500.0, jnp.float32)
get_scores = lambda er: (
    jnp.where(er[0] == 0, 1.0, jnp.where(er[0] == 1, 0.0, 0.5)),
    jnp.where(er[0] == 0, 0.0, jnp.where(er[0] == 1, 1.0, 0.5)))

elo_step = jax.jit(lambda a, d, e, el: pbt_update_elo(
    get_scores, a, d, e, el, mm))
t0 = time.perf_counter()
out = elo_step(asn, dns, ers, elos)
jax.block_until_ready(out)
print(f"elo-step compile {time.perf_counter()-t0:.2f}s", flush=True)
t0 = time.perf_counter()
for _ in range(50):
    out = elo_step(asn, dns, ers, out)
jax.device_get(out)
dt = (time.perf_counter() - t0) / 50
print(f"elo update step ({P_ELO} policies, {M} matches): {dt*1e6:.0f} us",
      flush=True)
