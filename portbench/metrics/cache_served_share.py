"""Decisions the dispatcher's cache served: decisions less the runs of the
tuner chain (its first link's bridge calls), over decisions, in percent."""


def read(obs):
    n = obs.get("decisions")
    if not n or "tuner_chain_runs" not in obs:
        return None
    return 100.0 * (n - obs["tuner_chain_runs"]) / n
