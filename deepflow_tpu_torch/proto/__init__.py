"""Wire messages: a dependency-free codec for the device-span protos."""
