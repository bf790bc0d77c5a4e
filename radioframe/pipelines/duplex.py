"""Full duplex: RX DDC chain + TX DUC chain in ONE jitted program
(BASELINE.json config 4; reference analog: `[U:trx_manager.c]` PTT switching
— except this chain is truly full duplex, both directions every block).
"""

from __future__ import annotations

from radioframe.core.config import RxConfig, TxConfig
from radioframe.pipelines.rx_chain import RxChain
from radioframe.pipelines.tx_chain import TxChain


class DuplexChain:
    def __init__(self, rx_cfg: RxConfig, tx_cfg: TxConfig):
        self.rx = RxChain(rx_cfg)
        self.tx = TxChain(tx_cfg)

    def init_state(self, num_channels: int | None = None):
        return {
            "rx": self.rx.init_state(num_channels),
            "tx": self.tx.init_state(num_channels),
        }

    def step(self, state, rx_iq, tx_audio, rx_words, rx_mode, tx_words, tx_mode):
        """One full-duplex block: returns (state, rx_audio, tx_iq, rx_aux)."""
        rx_state, rx_audio, rx_aux = self.rx.step(state["rx"], rx_iq, rx_words, rx_mode)
        tx_state, tx_iq = self.tx.step(state["tx"], tx_audio, tx_words, tx_mode)
        return {"rx": rx_state, "tx": tx_state}, rx_audio, tx_iq, rx_aux
