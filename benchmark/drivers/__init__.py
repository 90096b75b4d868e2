"""One driver per kind of loop a traffic file names (``"driver"``): each
builds the inputs from the seed, sets the program up, runs the window,
and hands what the window produced to the check.

A driver module has
  ``inputs(cfg, mix, seed, device)``: what the check compares on, from the seed;
  ``setup(cfg, mix, seed, device)``: the program, warmed up, as a state;
  ``window(state, seconds)``: ``(metrics, attempted, failed)``;
  ``traced_window(state, traced)``: a fixed amount of the cell's work with
    ``traced`` (a ``core.trace.Traced``) entered around it; returns the
    counts the per-layer readers need;
  ``outputs(state)``: what the program produced, for the check;
  ``reference(cfg, mix, inputs, precision)``: the same from the reference;
  ``compare(program, reference)``: ``{number: value}``.
"""
