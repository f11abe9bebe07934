"""The operation and byte counts behind mfu.* and *_roofline.*, against
counts made by hand at width 4 and depth 2."""

from portbench import flops as FL

H, NH = 4, 2  # width 4; MLPs of 2 hidden layers


def test_mlp_ops_by_hand():
    # 3 -> 4 -> 4 -> 4 -> 5 on 10 rows: MACs 12 + 16 + 16 + 20 = 64 a row
    assert FL.mlp_ops(10, 3, H, 5, NH) == 2 * 10 * 64


def test_mgn_layer_ops_by_hand():
    # n = 5 nodes, e = 7 edges. Edge MLP, concat trick: W_e (16 MACs),
    # 2 hidden (16 each), out (16) = 64 MACs an edge = 448; W_s, W_d on
    # nodes 2 x 16 = 32 a node = 160; node MLP 8 -> 4 -> 4 -> 4 -> 4: 32 +
    # 16 + 16 + 16 = 80 a node = 400. 1008 MACs.
    assert FL.layer_ops(5, 7, H, NH) == 2 * 1008


def test_mgn_forward_depth_2_by_hand():
    cfg = {"model": {"hidden_dim": H, "num_hidden_layers_edge_processor": NH},
           "dims": {"input_node_dim": 6, "input_edge_dim": 3,
                    "output_node_dim": 4}}
    # encoders: node 6->4->4->4->4 = 24+48 = 72 MACs x 5; edge 3->4.. =
    # 12+48 = 60 x 7; decoder 4->4->4->4->4 = 64 x 5. Layers 2 x 1008.
    macs = 72 * 5 + 60 * 7 + 64 * 5 + 2 * 1008
    assert FL.forward_ops(cfg, [(2, 5, 7)]) == 2 * macs
    assert FL.train_ops(cfg, [(2, 5, 7)]) == 3 * 2 * macs


def test_bsms_level_by_hand():
    cfg = {"model": {"hidden_dim": H, "num_hidden_layers_edge_processor": NH},
           "dims": {"input_node_dim": 6, "input_edge_dim": 3,
                    "output_node_dim": 4}}
    # fine 4 layers on (5, 7), one coarse level with 1 layer on (3, 4):
    # encoders and decoder on the fine sizes only
    fine = 72 * 5 + 60 * 7 + 64 * 5 + 4 * 1008
    coarse = 1 * (4 * 64 + 3 * 32 + 3 * 80)
    assert FL.forward_ops(cfg, [(4, 5, 7), (1, 3, 4)]) == 2 * (fine + coarse)


def test_edge_layer_work_by_hand():
    # forward, bf16 (2 B), n = 5, e = 7: reads e, sg (7 x 4 each), d_proj
    # (5 x 4), mask (7), weights (4 x 16 + 3 x 4 + 8 = 84) at 2 B = 2 x
    # (56 + 20 + 7 + 84) = 334, receivers 28; writes e', agg = 2 x 48 = 96
    ops, nbytes = FL.edge_fwd_work(5, 7, H, NH, 2)
    assert ops == 2 * 7 * 64 and nbytes == 334 + 28 + 96
    # backward: + cotangents e' (28) and agg (20) read; d_e, d_sg, d_dproj
    # (76) and the weight gradients (84) written; three forwards' MACs
    ops, nbytes = FL.edge_bwd_work(5, 7, H, NH, 2)
    assert ops == 3 * 2 * 7 * 64
    assert nbytes == 2 * (84 + 20 + 20 + 7 + 84) + 28 + 2 * (76 + 84)
    assert FL.least_seconds(10, 100, 1.0, 50.0) == 10.0
    assert FL.least_seconds(10, 1000, 1.0, 50.0) == 20.0
