"""Float LSTM, integer layer executors and the stacked recurrent LM."""
