"""setup.gn_s: seconds of the Kronecker Gauss-Newton set-up, the sum of
``shared_gn_setup``'s stage timings (each stage ends in a synchronize)."""


def read(run):
    return run.timings.get("gn_s")
