from .prng import (
    PRNGType,
    Blake2xbPRNG,
    Shake256PRNG,
    UniformRandomGeneratorFactory,
    UniformRandomGeneratorInfo,
    random_seed,
)
