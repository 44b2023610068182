"""The HLO collective parser the sharding tests assert with."""

import hlo_collectives as hc


def test_shape_bytes_and_replica_group_syntaxes():
    assert hc.shape_bytes("f32[4,8]{1,0}") == 128
    assert hc.shape_bytes("(bf16[2,3], s32[5], pred[])") == 12 + 20 + 1
    explicit = 'x = f32[8] all-reduce(y), replica_groups={{0,2},{1,3}}, '
    assert hc.parse_replica_groups(explicit, 4) == [
        frozenset({0, 2}), frozenset({1, 3})]
    iota = 'x = f32[8] all-reduce(y), replica_groups=[2,2]<=[2,2]T(1,0), '
    assert hc.parse_replica_groups(iota, 4) == [
        frozenset({0, 2}), frozenset({1, 3})]
    permute = ('x = f32[8] collective-permute(y), '
               'source_target_pairs={{0,1},{1,0}}, ')
    assert hc.parse_permute_pairs(permute) == [(0, 1), (1, 0)]


def test_collectives_classified_by_mesh_axis_and_phase():
    groups = hc.mesh_axis_groups(data=2, policy=2)
    # id = d * policy + p: data groups pair ids 0,2 and 1,3.
    assert hc.classify_axis([frozenset({0, 2}), frozenset({1, 3})],
                            groups) == "data"
    assert hc.classify_axis([frozenset({0, 1}), frozenset({2, 3})],
                            groups) == "policy"
    hlo = (
        '  %all-gather.1 = f32[4,8]{1,0} all-gather(f32[2,8]{1,0} %p), '
        'replica_groups={{0,2},{1,3}}, dimensions={0}, '
        'metadata={op_name="jit(f)/Update Iter/Learn/Optimize/while/body/'
        'x"}\n')
    static = {"steps_per_update": 8, "num_bptt_chunks": 2,
              "num_epochs": 3, "num_minibatches": 2}
    (row,) = hc.parse_collectives(hlo, data=2, policy=2,
                                  static_loops=static)
    assert (row["kind"], row["axis"], row["phase"]) == (
        "all-gather", "data", "Learn")
    assert row["global_bytes"] == 128 and row["shard_bytes"] == 64
    assert row["mult"] == 3  # one while level inside Learn: per epoch
