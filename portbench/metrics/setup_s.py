"""Set-up: from the harness's first line to the first timed dispatch
(imports, CUDA context, building or loading the kernels, the inputs, the
warm-up call), host clock."""


def read(rec):
    return rec.setup_s
