"""Faults planted under the timed path, for test_rtbench_faults.py: each
takes the benchmark's program module and returns a stand-in with one of
its entries broken."""

import dataclasses
import types

import torch


def _with(program, **entries):
    ns = types.SimpleNamespace(**vars(program))
    ns.__dict__.update(entries)
    return ns


def _mix(old, new, rows):
    """`new` where rows (of [ny, nx, 3]) are selected, `old` elsewhere."""
    out = old.clone()
    out[rows] = new[rows]
    return out


# --- progressive frames (render_with_stats) --------------------------------

def frames_unchanged(program):
    def frame(scene, cam, config, state):
        new, seg = program.frame(scene, cam, config, state)
        return type(new)(state.raw_sum, new.sample_count), seg
    return _with(program, frame=frame)


def frames_half(program):
    def frame(scene, cam, config, state):
        new, seg = program.frame(scene, cam, config, state)
        raw = _mix(state.raw_sum, new.raw_sum, slice(0, config.ny // 2))
        return type(new)(raw, new.sample_count), seg // 2
    return _with(program, frame=frame)


def frames_altered(program):
    def frame(scene, cam, config, state):
        new, seg = program.frame(scene, cam, config, state)
        raw = new.raw_sum - 0.01 * (new.raw_sum - state.raw_sum)
        return type(new)(raw, new.sample_count), seg
    return _with(program, frame=frame)


# --- training steps (train_step_fused) -------------------------------------

def steps_unchanged(program):
    def train_step(params, *a, **kw):
        _, loss, left = program.train_step(params, *a, **kw)
        return params, loss, left
    return _with(program, train_step=train_step)


def steps_half(program):
    """The loss over the frame's first half of rows, its mean taken over
    them: the step of a mesh of two ranks on rank 0 alone, whose loss and
    gradient count the whole frame, doubled."""
    def train_step(params, rest, cam, config, target, mesh, n_iters, lr):
        half = dataclasses.replace(mesh, size=2, rank=0)
        p, loss, left = program.train_step(params, rest, cam, config, target,
                                           half, n_iters, 2 * lr)
        return p, 2 * loss, left
    return _with(program, train_step=train_step)


def steps_altered(program):
    def train_step(*a, **kw):
        p, loss, left = program.train_step(*a, **kw)
        return p, loss * 1.01, left
    return _with(program, train_step=train_step)


def steps_rerouted(program):
    """Steps whose forward pool no longer goes through
    `pool_fused.render_pool_fused` (as if a later change routed it
    elsewhere): the harness can no longer read their segments."""
    from scheme_raytrace_torch.integrator import pool_fused
    plain = pool_fused.render_pool_fused        # before the harness wraps it

    def train_step(*a, **kw):
        wrapped = pool_fused.render_pool_fused
        pool_fused.render_pool_fused = plain
        try:
            return program.train_step(*a, **kw)
        finally:
            pool_fused.render_pool_fused = wrapped
    return _with(program, train_step=train_step)
