"""The benchmark's plain reference: what decides ``correct``.

Most modules here are frozen copies of the port's (``univs_tpu_torch``)
model code, inference laws, criterion and draws, taken at the commit that
added the benchmark, so that a later change to the program cannot move
the yardstick.  They differ from the port's files only where listed:
imports point here; the three encoder kernels are replaced by their
plain laws (``ops/plain.py``); a backbone is built by its family's file
(``models/backbones/<family>.py``, found by name: ``resnet``, ``swin``;
no PVT yet); the pixel decoder can recompute its encoder layers in the
backward (``remat``, set by ``train.py``); ``parallel/ddp.py`` keeps only
the one-process ``BatchShard``; ``rle.py`` keeps the decode alone.
``univs.py`` (the model, the VIS and VSS loops, after the port's drivers),
``train.py`` (the train step after ``parallel/train_state.py``, and the
compared numbers) and ``quant.py`` (the fp8 control) are the benchmark's.
Nothing here imports the program, JAX or ``univs_tpu``.
"""
