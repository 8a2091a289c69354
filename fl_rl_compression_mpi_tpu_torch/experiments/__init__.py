"""The port's experiment entry points: the archived TPU studies of
``experiments/`` whose kernels compute a function no product kernel
computes, run on the card through their hand-written Hopper kernels.

==========================  ==================================================
``exp21_tile_packed``       tile-packed fields behind a cursor
                            (``ops/tile_packed_cuda``, cursor layout)
``exp22_tile_packed2``      the same, tile-aligned sparse layout
``exp30_rl_starts``         the RL encode routing piece starts
                            (``rl_cuda.encode_starts``)
``exp33_round_latency``     64 dependent rounds of y·3 + roll(y, 1)
                            (``lanes_cuda.rounds``)
``exp6_r2_tuning``          the pure copy (``copy_probe_cuda.copy``)
==========================  ==================================================

Each keeps its JAX script's function names and runs what the script ran
with ``python -m fl_rl_compression_mpi_tpu_torch.experiments.<name>``: on
the card unless ``--device cpu`` is given (the plain versions, for tests),
``--smoke`` for a small size.  Nothing runs on import.
"""
