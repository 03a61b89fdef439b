"""Host-clock time of one validation pass (``tasks/age.py`` ``validate``:
``Trainer.predict``, which ends in a copy to the host, and the shot
metrics): the mean over the window's passes outside the profiled epoch, or
the profiled epoch's where the window has no other."""


def read(obs):
    epochs = [e for e in obs.epochs if "validate" in e["phases"]]
    plain = [e["phases"]["validate"] for e in epochs if not e["profiled"]]
    times = plain or [e["phases"]["validate"] for e in epochs]
    return 1e3 * sum(times) / len(times) if times else None
