"""radioframe — a software-defined-radio signal-chain framework in JAX.

A JAX (XLA / Pallas through Triton / shard_map) framework with the
signal-processing capabilities of the UA3REO "Wolf" DDC/DUC transceiver
firmware (reference: Airtau-DSP/UA3REO-DDC-Transceiver; see SURVEY.md for the
full structural analysis — the reference mount was empty this round, so
capability citations are to SURVEY.md sections and BASELINE.json lines).

Layers (after SURVEY.md §1's layer map):
  A6  CLI / examples / benchmark harness          (bench.py, radioframe.api)
  A5  Pipelines: RxChain / TxChain / Channelizer  (radioframe.pipelines)
  A4  Sharding: channel/time meshes, halo coll.   (radioframe.shard)
  A3  Ops: NCO, CIC, FIR, OLS, AGC, demod/mod     (radioframe.ops)
  A2  Pallas kernels through Triton (GPU)        (radioframe.kernels)
  A1  Core: block/stream model, state, config     (radioframe.core)
  A0  Golden numpy/scipy reference + fixtures     (radioframe.golden, .io)
"""

__version__ = "0.1.0"
