"""Seeds of the benchmark's generators, derived from ``--seed`` and a tag.

SplitMix64 (Steele, Lea and Flood, 2014), so neighbouring run seeds and tags
give unrelated streams; the result fits ``torch.Generator.manual_seed``."""

_MASK64 = (1 << 64) - 1

# stream tags: each names the use of one generator
DATA, INIT, SAMPLE, CAPTURE, SGD, JITTER = 1, 2, 4, 5, 6, 7


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive(seed: int, tag: int) -> int:
    """A 63-bit seed from the run seed (any whole number) and a stream tag."""
    return _splitmix64(_splitmix64(int(seed) & _MASK64) ^ int(tag)) >> 1
