"""FedAvg (McMahan et al. 2017): paper Eq. 1."""
from __future__ import annotations

from repro_torch.core.agg_engine import get_engine
from repro_torch.core.strategies.base import Strategy, register


@register
class FedAvg(Strategy):
    name = "fedavg"

    def post_exchange(self, fl_state, round_inputs, ctx):
        params, _global_row = get_engine().aggregate_round(
            fl_state["params"], round_inputs, ctx)
        # the global model in each leaf's dtype, as the reference unravels it
        fl_state["layout"].round_(params)
        return {**fl_state, "params": params}
