"""Host-clock time of one test pass (``tasks/nyud2.py`` ``test_epoch``:
each batch's prediction, which ends in a copy to the host, the host
upsample to the test depth's size, the balanced mask and the shot
metrics): the mean over the window's passes outside the profiled epoch,
or the profiled epoch's where the window has no other."""


def read(obs):
    epochs = [e for e in obs.epochs if "test" in e["phases"]]
    plain = [e["phases"]["test"] for e in epochs if not e["profiled"]]
    times = plain or [e["phases"]["test"] for e in epochs]
    return 1e3 * sum(times) / len(times) if times else None
