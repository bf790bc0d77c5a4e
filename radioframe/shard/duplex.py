"""Sharded full duplex: time+channel-sharded RX DDC and TX DUC in ONE
jitted SPMD program (BASELINE config 4 across devices)."""

from __future__ import annotations

from radioframe.pipelines.duplex import DuplexChain
from radioframe.shard.rx import ShardedRxChain
from radioframe.shard.tx import ShardedTxChain


class ShardedDuplex:
    def __init__(self, dpx: DuplexChain, mesh, channel_axis="channel", time_axis="time"):
        self.rx = ShardedRxChain(dpx.rx, mesh, channel_axis, time_axis)
        self.tx = ShardedTxChain(dpx.tx, mesh, channel_axis, time_axis)
        self.dpx = dpx

    def init_state(self, num_channels: int | None = None):
        return self.dpx.init_state(num_channels)

    def state_specs(self):
        """PartitionSpec tree for mesh.place_state (donation hygiene)."""
        return {"rx": self.rx.state_specs(), "tx": self.tx.state_specs()}

    def step(self, state, rx_iq, tx_audio, rx_words, rx_mode, tx_words, tx_mode):
        rx_state, rx_audio, rx_aux = self.rx.step(state["rx"], rx_iq, rx_words, rx_mode)
        tx_state, tx_iq = self.tx.step(state["tx"], tx_audio, tx_words, tx_mode)
        return {"rx": rx_state, "tx": tx_state}, rx_audio, tx_iq, rx_aux
