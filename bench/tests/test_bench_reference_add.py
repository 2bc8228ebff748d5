"""The add reference against hand-worked sums, its count of mismatches, its
bf16 control against the limit, its bytes and operations, and the port's
add path (the call the tuner's runner makes) against it on seeded inputs
at small sizes, on the CPU."""

from __future__ import annotations

import math

import pytest
import torch

from bench.harness import layout, program, runner

ADD = layout.reference("add")
H100 = layout.peaks()["NVIDIA H100 80GB HBM3"]


def test_add_by_hand():
    """Sums that float32 holds exactly, and one it rounds: 1 + 2**-24 is
    halfway between 1 and its successor and rounds to even, 1."""
    a = torch.tensor([[1.0, -2.5, 0.0], [3.0, 1e30, 1.0]])
    b = torch.tensor([[2.0, 2.5, -0.0], [-7.25, 1e30, 2.0**-24]])
    r = ADD.reference((a, b), 2, 3, "cpu")
    assert r.dtype == torch.float32 and r.shape == (2, 3)
    want = torch.tensor([[3.0, 0.0, 0.0], [-4.25, 2e30, 1.0]])
    assert torch.equal(r, want)


def test_make_inputs_are_two_seeded_images():
    a, b = ADD.make_inputs(5, 7, runner.bench_generator(2**31 + 9, "cpu"), "cpu")
    c, d = ADD.make_inputs(5, 7, runner.bench_generator(2**31 + 9, "cpu"), "cpu")
    assert a.shape == b.shape == (5, 7) and a.dtype == b.dtype == torch.float32
    assert torch.equal(a, c) and torch.equal(b, d) and not torch.equal(a, b)


def test_one_altered_element_counts_one():
    a, b = ADD.make_inputs(16, 24, runner.bench_generator(7, "cpu"), "cpu")
    ref = ADD.reference((a, b), 16, 24, "cpu")
    assert ADD.error(ref.clone(), ref) == 0
    out = ref.clone()
    out[5, 11] = torch.nextafter(out[5, 11], torch.tensor(math.inf))
    assert ADD.error(out, ref) == 1
    assert ADD.CHECK == "add_mismatch" and ADD.LIMIT == 0


def test_add_control_fails_its_limit():
    a, b = ADD.make_inputs(64, 256, runner.bench_generator(5, "cpu"), "cpu")
    ref = ADD.reference((a, b), 64, 256, "cpu")
    mismatched = ADD.error(ADD.control((a, b), 64, 256, "cpu"), ref)
    assert mismatched > ADD.LIMIT
    # bf16 keeps 8 bits of a standard-normal sum: nearly every element moves
    assert mismatched > 0.9 * 64 * 256


def test_add_counts_and_bound_at_8192():
    """Two reads and one write of 4 bytes an element, one addition an
    element; at 8192 x 8192 on the H100, 805,306,368 bytes at 3.35 TB/s,
    0.2404 ms, bound by bytes."""
    assert ADD.counts(3, 5, None) == (12 * 15, 15)
    nbytes, ops = ADD.counts(8192, 8192, None)
    assert nbytes == 805_306_368
    ms, by = runner.roofline_bound(nbytes, ops, H100)
    assert by == "bytes" and math.isclose(ms, 0.24039, rel_tol=1e-4)


#: configs of the paper's space, the default among them; at 37 x 300 and
#: 200 x 129 the tiles leave ragged row and column edges
CONFIGS = [
    runner.DEFAULT_CONFIG,
    {"t_x": 16, "t_y": 16, "t_z": 16, "w_x": 8, "w_y": 8, "w_z": 8},
    {"t_x": 3, "t_y": 5, "t_z": 2, "w_x": 7, "w_y": 1, "w_z": 4},
    {"t_x": 1, "t_y": 2, "t_z": 9, "w_x": 2, "w_y": 6, "w_z": 1},
]


@pytest.mark.parametrize("shape", [(64, 256), (37, 300), (200, 129)])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_the_ports_add_path_equals_the_reference(shape, config):
    x, y = shape
    inputs = ADD.make_inputs(x, y, runner.bench_generator(2**31 + x * y, "cpu"), "cpu")
    got = program.run_kernel("add", inputs, config, x, y, "cpu")
    assert got.shape == (x, y) and got.dtype == torch.float32
    assert ADD.error(got, ADD.reference(inputs, x, y, "cpu")) == 0
