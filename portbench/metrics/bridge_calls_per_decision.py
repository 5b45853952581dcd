"""Bridge calls over every attached link (each one a kernel launch and
its copies), per decide-and-feed step."""


def read(obs):
    n = obs.get("decisions")
    if not n or "bridge_calls" not in obs:
        return None
    return obs["bridge_calls"] / n
