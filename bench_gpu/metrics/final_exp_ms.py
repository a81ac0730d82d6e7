"""final_exp_ms (program span): ms a call in the fused tier's shared final
exponentiation and `fq12_is_one`, outside the independent tier, the median
over the window's calls."""

from bench_gpu import tracing as TR

SPANS = {"final_exp": ["bn254_tpu_torch.pairing.final_exp:final_exp",
                       "bn254_tpu_torch.fields.tower:fq12_is_one"],
         "fallback": [
             "bn254_tpu_torch.dist.batch_verify:verify_batch_independent"]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["final_exp"],
                                               outside=["fallback"]))
    return None if s is None else s * 1e3
