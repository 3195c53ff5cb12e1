"""Floors of the reference, one module a floor, found by the name a
configuration's ``reference.floor`` gives. Each has:

- ``terrain(captured, device, dtype)``: the reference's engine.Terrain (or
  None) from the terrain the program handed the captured launch (a dict of
  its fields, batch-leading tensors or None; None where it handed none);
- ``slot_kinds(model)``: the kind of every contact slot, for the counts
  ("flat" rows have 3 basis terms, any other kind 6);
- ``extra_bytes(model, batch)``: bytes a launch reads for the floor beyond
  the flat floor's rows.
"""
