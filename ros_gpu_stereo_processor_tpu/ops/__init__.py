"""Device compute ops: one pure-jnp implementation per op, left to XLA.

Each is tested against a CPU oracle (cv2 or numpy), mirroring the reference's
paired GPU/CPU matchers (src/GPUStereoProcessor.cpp:18-38).
"""
