"""The window's time inside profiler_feed (a harness span around each
call), over the window, in percent."""


def read(obs):
    if "feed_s" not in obs or not obs.get("window_s"):
        return None
    return 100.0 * obs["feed_s"] / obs["window_s"]
