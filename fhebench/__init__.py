"""The benchmark of sgfhe_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards.

One command runs one cell of `BENCHMARK.json` once:

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything here is found by name, so that a cell, a configuration, a
traffic mix or a metric is added with new files and new `BENCHMARK.json`
entries, without an edit to a file that is here:

  configs/<config>.json     the configuration as it is run: the scheme,
                            its parameters (held against the port's
                            `Params`), the guarantees, what is assumed
  traffic/<traffic>.json    a traffic mix: the driver that serves it and
                            its parameters (batch, pool, mode, circuits)
  drivers/<driver>.py       one general driver a kind of request: makes
                            the inputs, serves one request through the
                            port, hands the answers to the reference
  metrics/<family>.py       the reader of every metric named <family> or
                            <family>.<variant>: `read(run, variant)`
                            returns a number, or None where it finds
                            nothing to read; `SPANS` names the port's
                            entries it needs wrapped (hooks.py)
  limits/<cell>.json        the limit of each number that decides
                            `correct`
  reference/                the plain reference: LWE decryption with the
                            benchmark's secret key and the plaintext
                            results (numpy only)
  cost.py, chrome_trace.py, hooks.py
                            the rotation's work count, the reading of the
                            profiler's trace, and the spans the traced run
                            puts around the port's layers
  readings.py               a cell on many seeds in one process, as
                            configured or as a control, for the limits
  diagnose.py               a cell's requests one by one with what the
                            host and the device did in each, for finding
                            why runs spread
  tests/                    CPU tests (`python -m pytest fhebench/tests`);
                            the one marked `cuda` runs on a card

Nothing here imports JAX or the JAX package `sgfhe_tpu`.
"""
