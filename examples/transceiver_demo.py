"""Transceiver control-plane demo: CAT protocol + PTT/split over the duplex chain.

Drives the Kenwood-dialect CatServer exactly like rig-control software
would (semicolon-terminated ASCII), showing the reference's control
surface (`[U:cat.c]`/`[U:trx_manager.c]`) living on top of the duplex
pipeline: tune, set mode, split, key PTT, read the S-meter and IF frame.
"""

import numpy as np

from radioframe.api.cat import CatServer
from radioframe.api.transceiver import Transceiver
from radioframe.core.config import RxConfig, TxConfig
from radioframe.io import fixtures as FX


def main():
    trx = Transceiver(RxConfig(channels=1), TxConfig(channels=1))
    cat = CatServer(trx)

    # a rig-control session
    print("> FA00007100000; MD2; FT1; FB00007105000;   (tune, USB, split)")
    cat.handle("FA00007100000;MD2;FT1;FB00007105000;")
    print(f"  rx {trx.rx_frequency(0)/1e6:.4f} MHz  tx {trx.tx_frequency(0)/1e6:.4f} MHz"
          f"  mode {trx.mode(0)}  split {bool(trx._split[0])}")
    print("> IF;  ->", cat.handle("IF;"))

    # receive a block: SSB signal at the tuned offset (baseband capture)
    iq, _truth = FX.ssb_capture(trx.rx_cfg.fs_in, 8 * trx.chain.rx.min_block, 37_000.0)
    trx._vfo_a[0] = 37_000.0  # retune within the capture
    audio, _ = trx.process(iq.astype(np.complex64), np.zeros(len(iq) // trx.rx_cfg.decim, np.float32))
    print(f"RX audio power {10*np.log10(np.mean(audio**2)+1e-30):.1f} dB, "
          f"S-meter {trx.s_meter(0)}  (CAT SM: {cat.handle('SM0;')})")

    # key PTT over CAT: RX mutes, TX IQ flows
    cat.handle("TX;")
    mic = FX.voicelike_audio(48_000.0, len(iq) // trx.rx_cfg.decim).astype(np.float32)
    audio_tx, tx_iq = trx.process(iq.astype(np.complex64), mic)
    print(f"PTT keyed: rx_audio muted={not audio_tx.any()}, "
          f"tx power {10*np.log10(np.mean(np.abs(tx_iq)**2)+1e-30):.1f} dB")
    cat.handle("RX;")
    print("> RX;  transmitting =", trx.transmitting)


if __name__ == "__main__":
    main()
