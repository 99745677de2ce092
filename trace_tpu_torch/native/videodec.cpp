// Native batched random-access video frame extractor (a copy of
// trace_tpu/native/videodec.cpp, built separately for the port).
//
// libavformat demux + libavcodec decode + swscale RGB24 conversion, with
// keyframe-aware seeking so sparse index sets (uniform sampling over long
// videos) skip decode work between samples. It stands in for decord's
// VideoReader, which the reference uses for frame decode (reference
// trace/mm_utils.py:13,425-435).
//
// C ABI (consumed by trace_tpu_torch/native/videodec.py via ctypes):
//   vd_probe(path, &frames, &fps, &w, &h)            -> 0 on success
//   vd_read_frames(path, indices, n, out_rgb, w, h)  -> 0 on success
//     out_rgb must hold n*h*w*3 bytes; frames land in index order.
//   vd_last_error()                                  -> thread-local error string

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

static thread_local std::string g_error;

static void set_error(const std::string& msg) { g_error = msg; }

extern "C" const char* vd_last_error() { return g_error.c_str(); }

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  AVRational avg_frame_rate{0, 1};

  ~Reader() {
    if (sws) sws_freeContext(sws);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  bool open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
      set_error(std::string("cannot open ") + path);
      return false;
    }
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
      set_error("no stream info");
      return false;
    }
    const AVCodec* dec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (stream_index < 0 || !dec) {
      set_error("no video stream");
      return false;
    }
    AVStream* st = fmt->streams[stream_index];
    avg_frame_rate = st->avg_frame_rate.num > 0 ? st->avg_frame_rate
                                                : AVRational{30, 1};
    codec = avcodec_alloc_context3(dec);
    if (!codec ||
        avcodec_parameters_to_context(codec, st->codecpar) < 0 ||
        avcodec_open2(codec, dec, nullptr) < 0) {
      set_error("cannot open decoder");
      return false;
    }
    codec->thread_count = 0;  // auto
    return true;
  }

  int64_t frame_to_ts(int64_t frame) const {
    AVStream* st = fmt->streams[stream_index];
    // frame index -> stream timestamp via the average frame rate
    return av_rescale_q(frame, av_inv_q(avg_frame_rate), st->time_base);
  }

  int64_t ts_to_frame(int64_t ts) const {
    AVStream* st = fmt->streams[stream_index];
    return av_rescale_q(ts, st->time_base, av_inv_q(avg_frame_rate));
  }

  // swscale's SIMD output stores run past the end of a row whose bytes are
  // no multiple of the vector width (a 40-pixel RGB24 row is 120 bytes), so
  // it writes into rows of this scratch image, 64-byte aligned with 64 bytes
  // of slack, and only the frame's own bytes are copied to the caller.
  std::vector<uint8_t> scratch;

  bool to_rgb(AVFrame* frame, uint8_t* dst, int out_w, int out_h) {
    sws = sws_getCachedContext(sws, frame->width, frame->height,
                               (AVPixelFormat)frame->format, out_w, out_h,
                               AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                               nullptr, nullptr);
    if (!sws) {
      set_error("swscale init failed");
      return false;
    }
    const int row = 3 * out_w;
    const int stride = (row + 63) / 64 * 64;
    scratch.resize((size_t)stride * out_h + 128);
    uint8_t* base = scratch.data();
    base += (64 - reinterpret_cast<uintptr_t>(base) % 64) % 64;
    uint8_t* planes[1] = {base};
    int strides[1] = {stride};
    sws_scale(sws, frame->data, frame->linesize, 0, frame->height, planes,
              strides);
    for (int y = 0; y < out_h; ++y) {
      std::memcpy(dst + (size_t)row * y, base + (size_t)stride * y, row);
    }
    return true;
  }
};

}  // namespace

extern "C" int vd_probe(const char* path, int64_t* num_frames, double* fps,
                        int* width, int* height) {
  Reader r;
  if (!r.open(path)) return -1;
  AVStream* st = r.fmt->streams[r.stream_index];
  *fps = av_q2d(r.avg_frame_rate);
  *width = r.codec->width;
  *height = r.codec->height;
  int64_t n = st->nb_frames;
  if (n <= 0 && st->duration > 0) {
    n = r.ts_to_frame(st->duration);
  }
  if (n <= 0 && r.fmt->duration > 0) {
    n = (int64_t)(*fps * (double)r.fmt->duration / AV_TIME_BASE);
  }
  *num_frames = n;
  return n > 0 ? 0 : -1;
}

extern "C" int vd_read_frames(const char* path, const int64_t* indices,
                              int n, uint8_t* out_rgb, int out_w, int out_h) {
  Reader r;
  if (!r.open(path)) return -1;

  // Process in ascending frame order; scatter to the caller's index order.
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return indices[a] < indices[b]; });

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  const size_t frame_bytes = (size_t)out_w * out_h * 3;

  int64_t cur_frame = -1;   // index of the last decoded frame
  bool need_seek = true;
  int ret_code = 0;

  for (int oi = 0; oi < n && ret_code == 0; ++oi) {
    const int64_t target = indices[order[oi]];
    uint8_t* dst = out_rgb + frame_bytes * order[oi];

    // exact duplicate of the previous target: re-decode is unnecessary, but
    // we no longer hold the pixels — cheapest correct answer is to copy the
    // previous output slot.
    if (oi > 0 && indices[order[oi - 1]] == target) {
      std::memcpy(dst, out_rgb + frame_bytes * order[oi - 1], frame_bytes);
      continue;
    }

    // seek when jumping backwards or far forwards (> ~2s of frames)
    const int64_t gap_limit =
        std::max<int64_t>(16, (int64_t)(2.0 * av_q2d(r.avg_frame_rate)));
    if (target < cur_frame || target > cur_frame + gap_limit || need_seek) {
      const int64_t ts = r.frame_to_ts(target);
      if (av_seek_frame(r.fmt, r.stream_index, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
        avcodec_flush_buffers(r.codec);
        cur_frame = -1;  // unknown until the first decoded pts
      }
      need_seek = false;
    }

    bool got = false;
    while (!got) {
      int rr = av_read_frame(r.fmt, pkt);
      if (rr < 0) {
        // EOF: flush the decoder
        avcodec_send_packet(r.codec, nullptr);
      } else if (pkt->stream_index != r.stream_index) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(r.codec, pkt);
        av_packet_unref(pkt);
      }
      while (true) {
        int dr = avcodec_receive_frame(r.codec, frame);
        if (dr == AVERROR(EAGAIN)) break;
        if (dr == AVERROR_EOF) {
          set_error("EOF before reaching frame " + std::to_string(target));
          ret_code = -2;
          got = true;
          break;
        }
        if (dr < 0) {
          set_error("decode error");
          ret_code = -3;
          got = true;
          break;
        }
        int64_t pts = frame->best_effort_timestamp;
        cur_frame = (pts == AV_NOPTS_VALUE) ? cur_frame + 1
                                            : r.ts_to_frame(pts);
        if (cur_frame >= target) {
          if (!r.to_rgb(frame, dst, out_w, out_h)) ret_code = -4;
          got = true;
          av_frame_unref(frame);
          break;
        }
        av_frame_unref(frame);
      }
      if (rr < 0 && !got) {
        set_error("EOF before reaching frame " + std::to_string(target));
        ret_code = -2;
        break;
      }
    }
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  return ret_code;
}
