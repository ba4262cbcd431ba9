"""Seconds the process spent loading the port's CUDA kernel variants in
set-up, less nvcc's builds: the program's process counters
`kernels.load_s` (the nvcc version query, the hash of the sources, nvcc's
build where the checkout has no library yet, and the dlopen) minus
`kernels.build_s` (the builds alone).  A build comes only on a checkout's
first run, so leaving it out keeps the number from reading which run of a
checkout was traced.  0 where no kernel was loaded; None where the program
has no such counters."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    return float(telemetry.counter("kernels.load_s")
                 - telemetry.counter("kernels.build_s"))
