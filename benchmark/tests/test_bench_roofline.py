"""The roofline's counts on small sizes, by hand."""

import json
import os

import pytest

from benchmark import peaks
from benchmark.reference.params import CURVES
from benchmark.run import BENCH, load_module


def test_point_op_products():
    assert [peaks.point_products(o, 1) for o in ("madd", "add", "dbl")] == [11, 16, 7]
    assert [peaks.point_products(o, 2) for o in ("madd", "add", "dbl")] == [29, 43, 16]


def test_product_cost_takes_the_cheaper_route():
    # 381 bits: 12 words, 2*144 + 12 = 300 multiply-adds; 48 bytes, 2 (2*2304 + 48) = 9312 int8 ops
    imad, int8 = 300 / peaks.IMAD_PER_S, 9312 / peaks.INT8_OPS_PER_S
    assert peaks.product_s(381) == pytest.approx(min(imad, int8))
    assert peaks.product_s(381) <= imad and peaks.product_s(381) <= int8
    # 255 bits: 8 words -> 136; 32 bytes -> 2 (2048 + 32) = 4160
    assert peaks.product_s(255) == pytest.approx(min(136 / peaks.IMAD_PER_S, 4160 / peaks.INT8_OPS_PER_S))


def test_pippenger_by_hand():
    # n = 4, 2-bit scalars, G1: one unsigned window of c = 2 (3 buckets):
    # 4 madds + 2*3 adds = 44 + 96 = 140, cheaper than c = 1 (175), signed c = 1 (274), c = 2 (246)
    assert peaks.pippenger_products(4, 2, 1) == 140
    # one point, one bit: one window of one bucket: 11 + 2*16 = 43
    assert peaks.pippenger_products(1, 1, 1) == 43


def test_ec_fft_by_hand():
    c = CURVES["bn254_g1"]
    add, dbl = 16, 7
    ec = load_module("roofline", "ec_fft")
    # 2 points: one butterfly, twiddle 1: two adds
    assert ec.work({}, {"curve": "bn254_g1", "log_n": 1, "transforms": 3})["products"]["254"] == 3 * 2 * add
    # 4 points: stage 0 twiddles 1 and w (once each), stage 1 twiddle 1 twice
    w = c.root_of_unity(2)
    chain = (w.bit_length() - 1) * dbl + (bin(w).count("1") - 1) * add
    assert ec.work({}, {"curve": "bn254_g1", "log_n": 2, "transforms": 1})["products"]["254"] == 4 * 2 * add + chain


def test_commit_by_hand():
    c = load_module("roofline", "commit").work({}, {"curve": "bls12_381_g1", "log_n": 3})
    assert c["products"]["255"] == 4 * 3 + 8
    assert c["products"]["381"] == peaks.pippenger_products(8, 255, 1)
    assert c["bytes"] == 8 * 32 + 8 * 96 + 8 * 32 + 3 * 48


@pytest.mark.parametrize("traffic", sorted(os.listdir(os.path.join(BENCH, "workloads"))))
def test_least_time_is_below_both_routes(traffic):
    t = json.load(open(os.path.join(BENCH, "workloads", traffic)))
    w = load_module("roofline", t["op"]).work({}, t)
    for bits, p in w["products"].items():
        b = int(bits)
        words, nbytes = -(-b // 32), -(-b // 8)
        assert p * peaks.product_s(b) <= p * (2 * words * words + words) / peaks.IMAD_PER_S + 1e-15
        assert p * peaks.product_s(b) <= p * 2 * (2 * nbytes * nbytes + nbytes) / peaks.INT8_OPS_PER_S + 1e-15
    assert w["least_s"] == max(w["compute_s"], w["memory_s"]) > 0
