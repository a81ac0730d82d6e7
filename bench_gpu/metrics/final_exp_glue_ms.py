"""final_exp_glue_ms (program spans `final_exp.easy`, `final_exp.hard`,
`is_one`): ms a call in the fused tier's one-lane work around the three
`exp_u` (the easy part with `fq12_inv`, the hard combine, `fq12_is_one`),
outside the independent tier, the median over the window's calls."""

from bench_gpu import program_spans as PS

install = PS.install


def read(run):
    return PS.span_ms(run, ["final_exp.easy", "final_exp.hard", "is_one"],
                      outside=["independent"])
