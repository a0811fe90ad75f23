"""Native (C++) helpers of the data pipeline, built with g++ at first use."""
