"""The gridding pass, in the recipe of ``python -m idg_tpu_torch pipeline``:
visibilities in, c64[P, G, G] out.

  program   gridded_pipeline_parts: the gridder with its fused iDFT
            epilogue (K1 with K3) emits block-rolled pieces (span
            bench.gridder), the range grid-add (K4) sums them into the
            grid (span bench.grid_add).
  inputs    the observation of inputs.observation, then complex normal
            visibilities c64[S, T, C, P] drawn on the device.
  expected  reference.grid_pass: the grid, which no order changes.
"""

from benchmark import costs, inputs, passes, reference


def make_inputs(problem, traffic, seed, device):
    inp, gen = inputs.observation(problem, seed, device)
    inp.visibilities = inputs.visibilities(problem, gen, device)
    return inp


def build(problem, inp, device) -> passes.Pass:
    """The port's set-up on these inputs, timed by part."""
    from idg_tpu_torch.ops.api import gridded_pipeline_parts
    from idg_tpu_torch.ops.grid import plan_grid_add_ranges

    with passes.SetupClock(device) as clock:
        obs = passes.block_sorted(problem, inp)
        md = obs.metadata
        plan = plan_grid_add_ranges(md.coord_x, md.coord_y, problem.grid_size,
                                    problem.subgrid_size)
        clock.planned()
        pfn, pargs, gfn, version, _ = gridded_pipeline_parts(passes.params(problem), obs,
                                                             plan=plan, device=device)
        if pfn is None:
            raise RuntimeError(f"gridder {version} has no fused epilogue")
    stages = [("bench.gridder", lambda _: pfn(*pargs)), ("bench.grid_add", gfn)]
    return passes.Pass(stages, None, clock.plan_s, clock.stage_s, version)


def expected(problem, inp, rounding=reference.identity):
    return reference.grid_pass(problem, inp, rounding)


def pass_flops(problem) -> int:
    return costs.gridder_work(problem).flops
