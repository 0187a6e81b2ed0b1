"""CUDA-graph captures the collection made in the window (its compile_stats() "compiles", members included); 0 when every step replays."""


def read(obs):
    return obs.get("captures")
