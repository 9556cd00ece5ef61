"""Kinds of traffic, one module each, found by the mix's `kind` as
`portbench/kinds/<kind>.py`.  A mix file (`mixes/<traffic>.json`) holds
the parameters; its kind holds the code: how the inputs are made from
the seed, which entry point a call drives, what a call's work and least
time are, and what the reference answers.  A cell of an existing kind is
new data files; a new kind, entry point or answer is a new module here.

Each module provides, with `cell` the harness's `Cell` (its `config` and
`mix`) and `inputs` what `make_inputs` made (its `batches`: one call's
argument each, taken in turn; optionally `planted`: indices a batch that
the check's sample favours):

    make_inputs(cell, seed) -> inputs
    answers_per_call(inputs) -> int
    open_program(cell, inputs, device) -> call(batch) -> output
    open_control(cell, inputs, device, sampled) -> call(batch) -> output
        the control in the program's place (`sampled`: batch index ->
        the indices the check reads; only those need answers)
    keep(output, indices) -> (number of answers, answers by index)
    work(cell, inputs, b, kept) -> {unit: amount} of one completed call
    bound(cell, inputs, b, kept) -> {"bound_s": ...} by the cost model
    expected(cell, inputs, sample, device) -> {(b, i): answer}
"""
